"""The port's memory planner (``repro_torch.mem``) held against the JAX
package's ``repro.mem`` on shared fp64 inputs made with numpy from a seed.

- The Table-2 cost model (``policy_cost``, ``candidate_costs``,
  ``max_fitting_ncheck``, ``spill_callback_counts``) and the depth planner
  (``plan_depth_remat``) give equal integers and equal ``io_seconds``.
- ``plan_odeint(verify="model", explain=True)`` gives the reference's plan
  and report row for row.  The activation count is each package's own
  (a jaxpr's equations against aten ops on meta tensors), so the
  reference's ``f_activation_bytes`` is pinned to the port's count with
  ``monkeypatch`` to compare the walks on equal inputs.
- The measured mode on the CPU (live tensor storage) holds the
  reference's contracts of ``tests/test_mem.py``: the measured and the
  model order naive > pnode > pnode2, the pnode slope ratio in (0.2, 5),
  an anchor-budget plan that measures within its budget; and
  ``adjoint="auto"`` gradients equal the JAX naive gradient at rtol 1e-12
  / atol 1e-13 and the port's explicit chosen policy bitwise.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import implicit as jimp
from repro.mem import model as jmodel
from repro.mem import planner as jplanner
from repro_torch.core import adjoint as tadj
from repro_torch.core import implicit as timp
from repro_torch.kernels import ops
from repro_torch.mem import model as tmodel
from repro_torch.mem import planner as tplanner

D = 6
N_STEPS = 12
DT = 0.05
EXPLICIT = ["euler", "midpoint", "bosh3", "rk4", "dopri5"]
POLICIES = ["naive", "continuous", "anode", "aca", "pnode", "pnode2",
            "revolve", "revolve2"]
OFFLOADS = [None, "host", "spill", "disk"]
SNAPS = [None, 0, 3]
POL_RTOL, POL_ATOL = 1e-12, 1e-13
BUDGETS = [1_000, 2_000, 3_000, 5_000, 8_000, 12_000, 20_000, 50_000,
           10 ** 6, 10 ** 9]


@pytest.fixture(autouse=True)
def _x64_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax.enable_x64(True):
        yield
    torch.set_num_threads(prev)


def _problem_np(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(D), {"W": 0.3 * rs.randn(D, D), "b": 0.1 * rs.randn(D)}


def _jf(u, th, t):
    return jnp.tanh(th["W"] @ u + th["b"]) + 0.1 * jnp.sin(t) * u


def _tf(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) + 0.1 * math.sin(t) * u


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float64,
                        requires_grad=grad)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _same_cost(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b), (a, b)
    assert a.peak_bytes == b.peak_bytes


def _same_plan(a, b):
    for field in ("policy", "ncheck", "offload", "budget", "fits",
                  "measured_bytes", "snaps_in_ram", "snaps_on_disk",
                  "extra_fevals"):
        assert getattr(a, field) == getattr(b, field), field
    _same_cost(a.predicted, b.predicted)
    assert len(a.candidates) == len(b.candidates)
    for x, y in zip(a.candidates, b.candidates):
        _same_cost(x, y)
    assert [r.to_json() for r in a.report] == [r.to_json() for r in b.report]


# ---------------------------------------------------------------------------
# the Table-2 cost model, field for field
# ---------------------------------------------------------------------------

def _cost_or_error(mod, policy, **kw):
    try:
        return mod.policy_cost(policy, **kw)
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("method", EXPLICIT + ["beuler", "cn"])
def test_policy_cost_equals_the_reference(method):
    policies = (POLICIES if method in EXPLICIT
                else ["pnode", "revolve", "revolve2", "naive"])
    n = 0
    for policy in policies:
        ncheck = 3 if policy.startswith("revolve") else None
        for offload in OFFLOADS:
            for snaps in SNAPS:
                for segment in (None, 5):
                    kw = dict(method=method, n_steps=N_STEPS,
                              state_bytes=1536, theta_bytes=4096,
                              f_act_bytes=9000, ncheck=ncheck,
                              offload=offload, segment=segment,
                              newton_iters=6, gmres_iters=10,
                              snaps_in_ram=snaps)
                    a = _cost_or_error(tmodel, policy, **kw)
                    b = _cost_or_error(jmodel, policy, **kw)
                    if isinstance(b, type):
                        assert a is b, (policy, kw)
                    else:
                        _same_cost(a, b)
                        n += 1
    assert n >= 3 * len(OFFLOADS) * len(SNAPS) * 2


@pytest.mark.parametrize("method", EXPLICIT + ["beuler", "cn"])
def test_candidates_and_max_fitting_ncheck_equal_the_reference(method):
    opts = dict(newton_iters=6, gmres_iters=10)
    for budget in [None, 1, 10 ** 3, 10 ** 4, 3 * 10 ** 4, 10 ** 5,
                   10 ** 6]:
        kw = dict(method=method, n_steps=N_STEPS, state_bytes=512,
                  theta_bytes=2048, f_act_bytes=4000, mem_budget=budget,
                  solver_opts=opts)
        a, b = tplanner.candidate_costs(**kw), jplanner.candidate_costs(**kw)
        assert len(a) == len(b) >= 3
        for x, y in zip(a, b):
            _same_cost(x, y)
        if budget is not None:
            kw = dict(method=method, n_steps=N_STEPS, state_bytes=512,
                      theta_bytes=2048, **opts)
            assert tmodel.max_fitting_ncheck(budget, **kw) == \
                jmodel.max_fitting_ncheck(budget, **kw)


def test_spill_callback_counts_and_segments_equal_the_reference():
    from repro.mem.offload import default_segment
    for n in (1, 2, 7, 12, 30, 101):
        assert tmodel.default_segment(n) == default_segment(n)
    for n in (2, 7, 12, 30):
        cases = [("pnode", None, None), ("pnode", None, 2),
                 ("pnode", None, 5), ("naive", None, None)]
        cases += [(p, k, None) for p in ("revolve", "revolve2")
                  for k in range(1, min(n, 6))]
        for policy, ncheck, seg in cases:
            kw = dict(ncheck=ncheck, segment=seg)
            assert tmodel.spill_callback_counts(policy, n, **kw) == \
                jmodel.spill_callback_counts(policy, n, **kw), (policy, n, kw)


def test_plan_depth_remat_equals_the_reference():
    from repro.configs.base import ShapeCell as JCell
    from repro.configs.registry import get_arch as jget
    from repro_torch.configs.base import ShapeCell as TCell
    from repro_torch.configs.registry import get_arch as tget
    jcfg, tcfg = jget("smollm-135m"), tget("smollm-135m")
    jcell, tcell = JCell("t", 128, 8, "train"), TCell("t", 128, 8, "train")
    for budget in (10 ** 12, 10 ** 8, 10 ** 7, 10 ** 4):
        a = tplanner.plan_depth_remat(tcfg, tcell, budget)
        assert a == jplanner.plan_depth_remat(jcfg, jcell, budget)
        assert tplanner.depth_remat_live_bytes(tcfg, tcell, a[0], a[1]) == \
            jplanner.depth_remat_live_bytes(jcfg, jcell, a[0], a[1])
    assert [tplanner.plan_depth_remat(tcfg, tcell, b)[0] for b in
            (10 ** 12, 10 ** 8, 10 ** 7, 10 ** 4)][::3] == ["none", "revolve"]


# ---------------------------------------------------------------------------
# the planner's walk in model mode, row for row
# ---------------------------------------------------------------------------

def _pin_activation_count(monkeypatch, tf, u0, th):
    """Give the reference's walk the port's activation count."""
    fa = tmodel.f_activation_bytes(tf, u0, th)
    monkeypatch.setattr(jplanner, "f_activation_bytes",
                        lambda *a, **k: fa)
    return fa


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_plan_odeint_model_mode_equals_the_reference(monkeypatch, method,
                                                     batch):
    u0n, thn = _problem_np()
    _pin_activation_count(monkeypatch, _tf, _t(u0n), _t(thn))
    kw = dict(dt=DT, n_steps=N_STEPS, method=method, verify="model",
              explain=True, batch=batch)
    for budget in BUDGETS + [None, 1]:
        a = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), mem_budget=budget,
                                 **kw)
        b = jplanner.plan_odeint(_jf, _j(u0n), _j(thn), mem_budget=budget,
                                 **kw)
        _same_plan(a, b)
    for extra in (dict(ram_budget=1_000), dict(ram_budget=0),
                  dict(ram_budget=10 ** 6),
                  dict(ram_budget=1_000, disk_budget=10),
                  dict(mem_budget=1, ram_budget=2_000, disk_budget=10 ** 6),
                  dict(mem_budget=1, ram_budget=100, disk_budget=100),
                  dict(mem_budget=50_000, ram_budget=100)):
        a = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), **extra, **kw)
        b = jplanner.plan_odeint(_jf, _j(u0n), _j(thn), **extra, **kw)
        _same_plan(a, b)


def test_plan_odeint_refusals_equal_the_reference():
    u0n, thn = _problem_np()
    for bad in (dict(batch=0), dict(mem_budget=10, verify="hlo")):
        for mod, f, t in ((tplanner, _tf, _t), (jplanner, _jf, _j)):
            with pytest.raises(ValueError):
                mod.plan_odeint(f, t(u0n), t(thn), dt=DT, n_steps=N_STEPS,
                                **bad)


def _robertson_fold_port(u, c, t):
    k1, k2, k3 = (b * torch.exp(c[:, i]) for i, b in
                  enumerate((0.04, 3.0e7, 1.0e4)))
    du1 = -k1 * u[:, 0] + k3 * u[:, 1] * u[:, 2]
    du3 = k2 * u[:, 1] ** 2
    return torch.stack([du1, -du1 - du3, du3], dim=1)


def test_stiff_ensemble_plan_spills_on_both_sides(monkeypatch):
    """The call of ``benchmarks/stiff_ensemble.py:88-98`` at its sizes:
    1,024 Robertson systems, CN, 30 steps, one byte under the cheapest
    in-device candidate."""
    from benchmarks.stiff_ensemble import robertson_vf
    batch, n_steps, dt = 1024, 30, 0.01
    opts = dict(newton_iters=16, gmres_iters=5)
    u0n = np.tile([1.0, 0.0, 0.0], (batch, 1))
    c0n = np.zeros((batch, 3))
    u0, c0 = _t(u0n), _t(c0n)
    _pin_activation_count(monkeypatch, _robertson_fold_port, u0, c0)
    cands = tplanner.candidate_costs(
        method="cn", n_steps=n_steps, state_bytes=tmodel.tree_bytes(u0),
        theta_bytes=tmodel.tree_bytes(c0), solver_opts=opts)
    budget = int(min(c.peak_bytes for c in cands)) - 1
    kw = dict(dt=dt, n_steps=n_steps, method="cn", mem_budget=budget,
              verify="model", solver_opts=opts, explain=True)
    a = tplanner.plan_odeint(_robertson_fold_port, u0, c0, **kw)
    b = jplanner.plan_odeint(jax.vmap(robertson_vf, in_axes=(0, 0, None)),
                             _j(u0n), _j(c0n), **kw)
    _same_plan(a, b)
    assert a.offload == "spill" and a.policy == "pnode"


# ---------------------------------------------------------------------------
# the port's own activation count
# ---------------------------------------------------------------------------

def _mlp(depth):
    def f(u, th, t):
        for _ in range(depth):
            u = torch.tanh(th["W"] @ u + th["b"])
        return u
    return f


def test_f_activation_bytes_exceeds_the_state_and_grows_with_depth():
    u0n, thn = _problem_np()
    u0, th = _t(u0n), _t(thn)
    sb = tmodel.tree_bytes(u0)
    counts = [tmodel.f_activation_bytes(_mlp(d), u0, th) for d in
              (1, 2, 3, 4, 8)]
    assert counts[0] > sb
    per_layer = counts[1] - counts[0]
    assert per_layer > 0
    assert counts == [counts[0] + per_layer * (d - 1) for d in
                      (1, 2, 3, 4, 8)]
    # a vector field that reads a value on the host cannot run on meta
    # tensors: the count falls back to the state's bytes
    assert tmodel.f_activation_bytes(
        lambda u, th, t: u * float(u.sum()), u0, th) == sb
    assert tmodel.tree_bytes({"a": torch.empty(3, 4, device="meta"),
                              "b": 2.0}) == 48 + 8


# ---------------------------------------------------------------------------
# measured mode on the CPU: the reference's contracts
# ---------------------------------------------------------------------------

def _measure(policy, n_steps=N_STEPS, **kw):
    u0n, thn = _problem_np()
    return tmodel.measure_reverse_cost(
        _tf, _t(u0n), _t(thn), dt=DT, n_steps=n_steps, method="rk4",
        policy=policy, **kw)


def test_measured_and_model_order_naive_pnode_pnode2():
    u0n, thn = _problem_np()
    u0, th = _t(u0n), _t(thn)
    sb, tb = tmodel.tree_bytes(u0), tmodel.tree_bytes(th)
    fa = tmodel.f_activation_bytes(_tf, u0, th)
    assert fa > sb
    order = ["naive", "pnode", "pnode2"]
    measured = [_measure(p) for p in order]
    assert {m["source"] for m in measured} == {"live_tensors"}
    assert all(m["argument_bytes"] == sb + tb for m in measured)
    peaks = [m["peak_bytes"] for m in measured]
    predicted = [tmodel.policy_cost(p, method="rk4", n_steps=N_STEPS,
                                    state_bytes=sb, theta_bytes=tb,
                                    f_act_bytes=fa).peak_bytes
                 for p in order]
    assert peaks == sorted(peaks, reverse=True) and len(set(peaks)) == 3
    assert predicted == sorted(predicted, reverse=True)


def test_model_and_measured_pnode_slopes_agree():
    u0n, thn = _problem_np()
    sb, tb = tmodel.tree_bytes(_t(u0n)), tmodel.tree_bytes(_t(thn))

    def both(n):
        p = tmodel.policy_cost("pnode", method="rk4", n_steps=n,
                               state_bytes=sb, theta_bytes=tb).peak_bytes
        return _measure("pnode", n_steps=n)["peak_bytes"], p

    (m8, p8), (m16, p16) = both(8), both(16)
    assert m16 > m8 and p16 > p8
    assert 0.2 < ((p16 - p8) / 8) / ((m16 - m8) / 8) < 5.0


def _auto_grads(method, budget, **kw):
    u0n, thn = _problem_np()
    u0, th = _t(u0n, True), _t(thn, True)
    uf = tadj.odeint(_tf, u0, th, dt=DT, n_steps=N_STEPS, method=method,
                     **kw)
    return [g.numpy() for g in torch.autograd.grad(
        (uf ** 2).sum(), [u0, th["W"], th["b"]])]


def _jax_naive(method):
    u0n, thn = _problem_np()

    def loss(u0_, th_):
        uf = jadj.odeint(_jf, u0_, th_, dt=DT, n_steps=N_STEPS,
                         method=method, adjoint="naive")
        return jnp.sum(uf ** 2)

    gu, gth = jax.grad(loss, argnums=(0, 1))(_j(u0n), _j(thn))
    return [np.asarray(gu), np.asarray(gth["W"]), np.asarray(gth["b"])]


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
@pytest.mark.parametrize("anchor", [("pnode", None), ("pnode2", None),
                                    ("revolve", 3)],
                         ids=["pnode", "pnode2", "revolve3"])
def test_auto_plan_fits_its_anchor_budget_and_matches_naive(method, anchor):
    """The budget is the anchor policy's measured peak: the plan measures
    within it, its gradient is the explicit policy's bitwise and JAX's
    naive gradient within the reference's reverse-accuracy tolerance, and
    a second call measures nothing."""
    u0n, thn = _problem_np()
    policy, ncheck = anchor
    budget = tmodel.measure_reverse_cost(
        _tf, _t(u0n), _t(thn), dt=DT, n_steps=N_STEPS, method=method,
        policy=policy, ncheck=ncheck)["peak_bytes"]
    plan = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), dt=DT,
                                n_steps=N_STEPS, method=method,
                                mem_budget=budget, explain=True)
    assert plan.offload is None and plan.fits
    assert plan.measured_bytes is not None and plan.measured_bytes <= budget
    assert [r.chosen for r in plan.report].count(True) == 1
    before = tmodel.measurements
    auto = _auto_grads(method, budget, adjoint="auto", mem_budget=budget)
    assert tmodel.measurements == before
    again = _auto_grads(method, budget, adjoint="auto", mem_budget=budget)
    assert tmodel.measurements == before
    explicit = _auto_grads(method, budget, adjoint=plan.policy,
                           ncheck=plan.ncheck)
    for a, b, c in zip(auto, again, explicit):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b in zip(auto, _jax_naive(method)):
        np.testing.assert_allclose(a, b, rtol=POL_RTOL, atol=POL_ATOL)


def test_auto_fused_measures_the_fused_gradient_and_drops_fused_for_naive():
    u0n, thn = _problem_np()
    kw = dict(dt=DT, n_steps=N_STEPS, method="rk4")
    plan = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), mem_budget=10 ** 9,
                                fused_stages=True, **kw)
    assert plan.policy == "naive"
    np.testing.assert_array_equal(
        _auto_grads("rk4", None, adjoint="auto", mem_budget=10 ** 9,
                    fused_stages=True)[0],
        _auto_grads("rk4", None, adjoint="naive")[0])
    budget = _measure("pnode")["peak_bytes"]

    def fresh_f(u, th, t):  # a new function: no cached measurement
        return _tf(u, th, t)

    # the measured check runs the fused gradient (on the CPU the stage
    # kernel's plain version), as the auto solve will
    ops.reset_counts()
    plan = tplanner.plan_odeint(fresh_f, _t(u0n), _t(thn),
                                mem_budget=budget, fused_stages=True, **kw)
    assert plan.policy == "pnode"
    assert ops.plain_calls == tadj.expected_lincomb_calls("rk4", N_STEPS, 1,
                                                          "pnode")
    fused = tmodel.measure_reverse_cost(fresh_f, _t(u0n), _t(thn),
                                        policy="pnode", fused_stages=True,
                                        **kw)
    assert plan.measured_bytes == fused["peak_bytes"]
    for a, b in zip(_auto_grads("rk4", budget, adjoint="auto",
                                mem_budget=budget, fused_stages=True),
                    _auto_grads("rk4", budget, adjoint="pnode")):
        np.testing.assert_array_equal(a, b)


def test_measure_refuses_offload_and_a_capture(monkeypatch):
    """An offloaded gradient is measured on its tier: the host copies do
    not count, so spill's peak is under the device tier's (the staging
    segment and the prefetched one replace the N_t checkpoints); a miss
    while a CUDA graph captures is refused."""
    device = _measure("pnode")["peak_bytes"]
    for tier in ("spill", "disk"):
        m = _measure("pnode", offload=tier)
        assert m["source"] == "live_tensors"
        assert 0 < m["peak_bytes"] < device, (tier, m, device)

    def fresh_f(u, th, t):  # a new function: no cached measurement
        return _tf(u, th, t)

    monkeypatch.setattr(tmodel, "_capturing", lambda device: True)
    u0n, thn = _problem_np()
    with pytest.raises(RuntimeError, match="capturing"):
        tmodel.measure_reverse_cost(fresh_f, _t(u0n), _t(thn), dt=DT,
                                    n_steps=3)


def test_auto_without_budget_is_pnode_and_tiny_budget_plans_spill():
    u0n, thn = _problem_np()
    np.testing.assert_array_equal(
        _auto_grads("rk4", None, adjoint="auto")[1],
        _auto_grads("rk4", None, adjoint="pnode")[1])
    plan = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), dt=DT,
                                n_steps=N_STEPS, mem_budget=1,
                                verify="model")
    assert (plan.policy, plan.offload, plan.fits) == ("pnode", "spill",
                                                      False)
    measured = tplanner.plan_odeint(_tf, _t(u0n), _t(thn), dt=DT,
                                    n_steps=N_STEPS, mem_budget=1,
                                    verify="measure")
    assert (measured.policy, measured.offload) == ("pnode", "spill")
    assert measured.measured_bytes == _measure(
        "pnode", offload="spill")["peak_bytes"]
    pnode = _auto_grads("rk4", None, adjoint="pnode")
    for verify in ("model", "measure"):
        for a, b in zip(_auto_grads("rk4", 1, adjoint="auto", mem_budget=1,
                                    mem_verify=verify), pnode):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the implicit solver under the planner
# ---------------------------------------------------------------------------

def _jf_imp(u, th, t):
    return jnp.tanh(th["W"] @ u + th["b"]) - 0.5 * u


def _tf_imp(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u


@pytest.mark.parametrize("budget", [10 ** 9, 1_632, 1_584])
def test_odeint_implicit_auto_picks_the_references_policy(monkeypatch,
                                                          budget):
    u0n, thn = _problem_np(1)
    kw = dict(dt=0.2, n_steps=5, method="cn", adjoint="auto",
              mem_budget=budget, mem_verify="model", newton_iters=8,
              gmres_iters=6)
    opts = dict(newton_iters=8, newton_tol=1e-9, gmres_iters=6,
                gmres_tol=1e-10)
    plan = tplanner.plan_odeint(_tf_imp, _t(u0n), _t(thn), dt=0.2,
                                n_steps=5, method="cn", mem_budget=budget,
                                verify="model", solver_opts=opts)
    ref = jplanner.plan_odeint(_jf_imp, _j(u0n), _j(thn), dt=0.2,
                               n_steps=5, method="cn", mem_budget=budget,
                               verify="model", solver_opts=opts)
    assert (plan.policy, plan.ncheck, plan.offload) == \
        (ref.policy, ref.ncheck, None)
    assert plan.ncheck == {10 ** 9: 4, 1_632: 2, 1_584: 1}[budget]

    u, p = _t(u0n, True), _t(thn, True)
    uf = timp.odeint_implicit(_tf_imp, u, p, **kw)
    tg = torch.autograd.grad((uf ** 2).sum(), [u, p["W"], p["b"]])

    def loss(u_, p_):
        return jnp.sum(jimp.odeint_implicit(_jf_imp, u_, p_, **kw) ** 2)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(_j(u0n), _j(thn))
    for a, b in zip(tg, [jg[0], jg[1]["W"], jg[1]["b"]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)
    u, p = _t(u0n, True), _t(thn, True)
    uf = timp.odeint_implicit(_tf_imp, u, p, dt=0.2, n_steps=5, method="cn",
                              adjoint=plan.policy, ncheck=plan.ncheck,
                              newton_iters=8, gmres_iters=6)
    for a, b in zip(tg, torch.autograd.grad((uf ** 2).sum(),
                                            [u, p["W"], p["b"]])):
        assert torch.equal(a, b)


def test_odeint_implicit_auto_measure_mode_fits():
    u0n, thn = _problem_np(1)
    u, p = _t(u0n, True), _t(thn, True)
    budget = tmodel.measure_reverse_cost(
        _tf_imp, _t(u0n), _t(thn), dt=0.2, n_steps=5, method="cn",
        policy="revolve", ncheck=2,
        solver_opts=dict(newton_iters=10, newton_tol=1e-9, gmres_iters=20,
                         gmres_tol=1e-10))["peak_bytes"]
    uf = timp.odeint_implicit(_tf_imp, u, p, dt=0.2, n_steps=5, method="cn",
                              adjoint="auto", mem_budget=budget)
    g = torch.autograd.grad((uf ** 2).sum(), [u, p["W"]])
    u2, p2 = _t(u0n, True), _t(thn, True)
    uf2 = timp.odeint_implicit(_tf_imp, u2, p2, dt=0.2, n_steps=5,
                               method="cn")
    for a, b in zip(g, torch.autograd.grad((uf2 ** 2).sum(),
                                           [u2, p2["W"]])):
        assert torch.equal(a, b)  # the implicit policies agree bitwise
