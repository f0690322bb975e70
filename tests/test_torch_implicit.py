"""The port's implicit theta-method solvers (``repro_torch.core.implicit``)
held against the JAX package's ``repro.core.implicit`` on shared fp64
inputs made with numpy from a seed (x64 set on both sides).

- Forward states and the pnode / revolve / revolve2 gradients agree at
  rtol 1e-8 / atol 1e-10, the tolerance of ``tests/test_implicit.py``'s
  AD-through-the-solver contract: Newton and GMRES exit on tolerances
  (1e-9, 1e-10), so the two sides agree to well inside them, not to the
  ulp.
- Newton takes the same iterations on both sides (``ImplicitStats``).
- Inside the port the three policies give bitwise equal gradients (a
  recomputed state is the forward sweep's, bit for bit).
- The port's own contracts: convergence order 1 (beuler) and 2 (cn), the
  starved solve flagged ``diverged``, the mass-matrix form, the rescue,
  and agreement with AD through an unrolled dense Newton (torch.func).

The stiff Robertson example is held against the JAX package's in
``test_torch_stiff_robertson.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro.core import implicit as jimp
from repro_torch.core import implicit as timp

JAX_RTOL, JAX_ATOL = 1e-8, 1e-10
D = 5
DT, N = 0.2, 5
POLICIES = [("pnode", None), ("revolve", 2), ("revolve2", 2)]


@pytest.fixture(autouse=True)
def _x64_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax.enable_x64(True):
        yield
    torch.set_num_threads(prev)


def _problem_np(seed=1):
    rs = np.random.RandomState(seed)
    return rs.randn(D), {"W": 0.5 * rs.randn(D, D), "b": 0.1 * rs.randn(D)}


def _jf(u, th, t):
    return jnp.tanh(th["W"] @ u + th["b"]) - 0.5 * u + 0.1 * jnp.sin(t) * u


def _tf(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u \
        + 0.1 * torch.sin(torch.as_tensor(t, dtype=u.dtype)) * u


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(tree, dtype=torch.float64, requires_grad=grad)


def _jax_grads(u0, th, method, **kw):
    def loss(u, p):
        uf, st = jimp.odeint_implicit(_jf, u, p, dt=DT, n_steps=N,
                                      method=method, return_stats=True, **kw)
        return jnp.sum(uf ** 2), (uf, st)

    (_, (uf, st)), (gu, gth) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(u0), jax.tree_util.tree_map(jnp.asarray, th))
    return (np.asarray(uf), [np.asarray(gu), np.asarray(gth["W"]),
                             np.asarray(gth["b"])], st)


def _port_grads(u0, th, method, **kw):
    u, p = _t(u0, True), _t(th, True)
    uf, st = timp.odeint_implicit(_tf, u, p, dt=DT, n_steps=N, method=method,
                                  return_stats=True, **kw)
    g = torch.autograd.grad(torch.sum(uf ** 2), [u, p["W"], p["b"]])
    return uf.detach(), list(g), st


@pytest.mark.parametrize("method", ["beuler", "cn"])
@pytest.mark.parametrize("policy,ncheck", POLICIES,
                         ids=[p for p, _ in POLICIES])
def test_states_gradients_and_newton_iterations_match_jax(method, policy,
                                                          ncheck):
    u0, th = _problem_np()
    ju, jg, jst = _jax_grads(u0, th, method, adjoint=policy, ncheck=ncheck)
    tu, tg, st = _port_grads(u0, th, method, adjoint=policy, ncheck=ncheck)
    assert st.newton_iters == int(jst.newton_iters)
    assert st.diverged is False and not bool(jst.diverged)
    assert st.max_residual <= 1e-9
    np.testing.assert_allclose(tu.numpy(), ju, rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


@pytest.mark.parametrize("method", ["beuler", "cn"])
def test_policies_are_bitwise_equal_inside_the_port(method):
    u0, th = _problem_np()
    anchor = _port_grads(u0, th, method)
    for policy, ncheck in POLICIES[1:] + [("revolve", 1), ("revolve2", 3)]:
        out = _port_grads(u0, th, method, adjoint=policy, ncheck=ncheck)
        assert torch.equal(out[0], anchor[0])
        assert out[2] == anchor[2]
        for a, b in zip(out[1], anchor[1]):
            assert torch.equal(a, b), (policy, ncheck)


def test_implicit_step_and_adjoint_step_match_jax():
    u0, th = _problem_np()
    jv, jinfo = jimp.implicit_step(_jf, jnp.asarray(u0),
                                   jax.tree_util.tree_map(jnp.asarray, th),
                                   0.3, DT, 0.5)
    tv, info = timp.implicit_step(_tf, _t(u0), _t(th), 0.3, DT, 0.5)
    assert info.iters == int(jinfo.iters) and info.converged
    np.testing.assert_allclose(info.residual, float(jinfo.residual),
                               rtol=1e-3, atol=1e-15)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    lam = np.random.RandomState(5).randn(D)
    jl, jmu = jimp.implicit_adjoint_step(
        _jf, jnp.asarray(u0), jv, jax.tree_util.tree_map(jnp.asarray, th),
        0.3, DT, 0.5, jnp.asarray(lam))
    tl, tmu = timp.implicit_adjoint_step(_tf, _t(u0), tv, _t(th), 0.3, DT,
                                         0.5, _t(lam))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    for k in ("W", "b"):
        np.testing.assert_allclose(tmu[k].numpy(), np.asarray(jmu[k]),
                                   rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("method,order", [("beuler", 1), ("cn", 2)])
def test_forward_convergence_order(method, order):
    """As tests/test_implicit.py: against the exact solution of u' = A u."""
    a = np.diag([-4.0, -1.0])
    th = {"A": torch.tensor(a)}
    exact = scipy.linalg.expm(a) @ np.ones(2)
    errs = []
    for n in (20, 40, 80):
        uf = timp.odeint_implicit(lambda u, p, t: p["A"] @ u,
                                  torch.ones(2, dtype=torch.float64), th,
                                  dt=1.0 / n, n_steps=n, method=method)
        errs.append(float(np.max(np.abs(uf.numpy() - exact))))
    for e0, e1 in zip(errs, errs[1:]):
        assert abs(np.log2(e0 / e1) - order) < 0.35, errs


def test_starved_newton_surfaces_diverged():
    """As tests/test_implicit.py: one Newton iteration against an
    unreachable tolerance is flagged, on both sides alike."""
    u0, th = _problem_np()
    kw = dict(newton_iters=1, newton_tol=1e-16)
    _, _, jst = _jax_grads(u0, th, "cn", **kw)
    _, _, st = _port_grads(u0, th, "cn", **kw)
    assert st.diverged and bool(jst.diverged)
    assert st.max_residual > 1e-16
    assert st.newton_iters == int(jst.newton_iters) == N
    np.testing.assert_allclose(st.max_residual, float(jst.max_residual),
                               rtol=1e-6)


def test_rescue_converges_a_starved_step_like_jax():
    """The escalated retry (cap 1 -> 4 iterations) converges where the
    first attempt was starved; the rescued steps and the states agree
    with JAX's."""
    u0, th = _problem_np()
    kw = dict(newton_iters=1, rescue=timp.RescueConfig(max_retries=1,
                                                       escalate=4,
                                                       dt_halving=False))
    jkw = dict(kw, rescue=jimp.RescueConfig(max_retries=1, escalate=4,
                                           dt_halving=False))
    ju, jg, jst = _jax_grads(u0, th, "cn", **jkw)
    tu, tg, st = _port_grads(u0, th, "cn", **kw)
    assert st.rescued == int(jst.rescued) > 0
    assert st.diverged is False and not bool(jst.diverged)
    assert st.newton_iters == int(jst.newton_iters)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
    # a rescued solve that converges on the first attempt is the plain one
    plain = _port_grads(u0, th, "cn")
    resc = _port_grads(u0, th, "cn", rescue=True)
    assert resc[2].rescued == 0 and torch.equal(plain[0], resc[0])


def test_mass_matrix_form_matches_jax_and_the_exact_solution():
    """As tests/test_implicit.py: M u' = A u with a diagonal M."""
    m = np.diag([1.0, 2.0, 4.0])
    a = -np.eye(3)
    uf, st = timp.odeint_implicit(lambda u, p, t: p @ u,
                                  torch.ones(3, dtype=torch.float64),
                                  torch.tensor(a), dt=0.05, n_steps=40,
                                  method="beuler", mass=torch.tensor(m),
                                  return_stats=True)
    juf, jst = jimp.odeint_implicit(lambda u, p, t: p @ u, jnp.ones(3),
                                    jnp.asarray(a), dt=0.05, n_steps=40,
                                    method="beuler", mass=jnp.asarray(m),
                                    return_stats=True)
    exact = scipy.linalg.expm(np.linalg.inv(m) @ a * 2.0) @ np.ones(3)
    np.testing.assert_allclose(uf.numpy(), exact, rtol=0.05)
    np.testing.assert_allclose(uf.numpy(), np.asarray(juf), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    assert st.newton_iters == int(jst.newton_iters)
    with pytest.raises(ValueError, match="forward-only"):
        timp.odeint_implicit(lambda u, p, t: p @ u,
                             torch.ones(3, dtype=torch.float64),
                             torch.tensor(a, requires_grad=True), dt=0.05,
                             n_steps=2, method="beuler",
                             mass=torch.tensor(m))


@pytest.mark.parametrize("method", ["cn", "beuler"])
@pytest.mark.parametrize("policy,ncheck", POLICIES,
                         ids=[p for p, _ in POLICIES])
def test_policy_matches_ad_through_an_unrolled_dense_newton(method, policy,
                                                            ncheck):
    """As tests/test_reverse_accuracy.py: the discrete adjoint against AD
    through a fixed-iteration dense-Jacobian Newton of the same scheme
    (the oracle the matrix-free solver cannot be for itself), rtol 1e-7 /
    atol 1e-9."""
    theta = timp._theta_of(method)
    u0, th = _problem_np()

    def step(u, p, t_n):
        t_next = t_n + DT
        g_const = u + DT * (1 - theta) * _tf(u, p, t_n)
        v = u + DT * _tf(u, p, t_n)
        for _ in range(25):
            r = v - DT * theta * _tf(v, p, t_next) - g_const
            jac = torch.eye(D, dtype=torch.float64) - DT * theta \
                * torch.func.jacfwd(lambda uu: _tf(uu, p, t_next))(v)
            v = v - torch.linalg.solve(jac, r)
        return v

    u, p = _t(u0, True), _t(th, True)
    v = u
    for k in range(N):
        v = step(v, p, k * DT)
    oracle = torch.autograd.grad(torch.sum(v ** 2), [u, p["W"], p["b"]])
    _, g, _ = _port_grads(u0, th, method, adjoint=policy, ncheck=ncheck,
                          newton_iters=20, newton_tol=1e-13, gmres_tol=1e-13)
    for a, b in zip(g, oracle):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                   atol=1e-9)


def test_cost_model_matches_jax():
    for n in (1, 5, 12):
        for gi, ni in ((20, 10), (10, 6)):
            assert timp.implicit_nfe_forward(n, ni, gi) == \
                jimp.implicit_nfe_forward(n, ni, gi)
            for policy, ncheck in POLICIES:
                if ncheck is not None and ncheck >= n:
                    continue
                assert timp.implicit_nfe_backward(n, policy, ncheck, ni,
                                                  gi) == \
                    jimp.implicit_nfe_backward(n, policy, ncheck, ni, gi)
                assert timp.implicit_checkpoint_floats(n, policy, 7,
                                                       ncheck) == \
                    jimp.implicit_checkpoint_floats(n, policy, 7, ncheck)
    assert timp.implicit_step_fevals() == jimp.implicit_step_fevals()
    assert timp.implicit_adjoint_fevals(7) == jimp.implicit_adjoint_fevals(7)
    assert timp.IMPLICIT_METHODS == jimp.IMPLICIT_METHODS
    assert timp.IMPLICIT_POLICIES == jimp.IMPLICIT_POLICIES
    assert timp.is_implicit_method("cn") and not timp.is_implicit_method("rk4")


#: (keywords, what happens): the tiers on the eager route and a plan
#: that spills run; a knob without its tier (or host with pnode) is the
#: reference's ValueError; obs= (a recorder) and fault_plan= (a Newton
#: spec past the last step: the gated route, firing nowhere) run bitwise.
#: The ids are the cases' ids from when every one was refused.
OPTION_CASES = [
    (dict(offload="spill"), "runs"),
    (dict(offload="host"), "offload='host' applies"),
    (dict(offload="disk"), "runs"),
    (dict(offload_segment=2), "offload_segment only applies"),
    (dict(snaps_in_ram=1), "snaps_in_ram is the spill tier"),
    (dict(offload_dir="/x"), "offload_dir pins"),
    (dict(resilient=True), "resilient=True"),
    (dict(adjoint="auto", mem_budget=1), "runs"),
    (dict(adjoint="auto", mem_budget=1, mem_verify="model"), "runs"),
    (dict(obs="recorder"), "runs"), (dict(fault_plan="armed"), "runs")]


@pytest.mark.parametrize(
    "kw,outcome", OPTION_CASES,
    ids=[f"kw{i}-item {11 if i >= 9 else 10}" for i in range(11)])
def test_unported_options_raise_naming_their_roadmap_item(kw, outcome):
    """A budget under every in-device candidate plans the spill tier, which
    runs: every running case gives pnode's device gradient bitwise."""
    u0, th = _problem_np()
    if kw.get("obs") == "recorder":
        from repro_torch.obs import FlightRecorder
        kw = dict(kw, obs=FlightRecorder())
    if kw.get("fault_plan") == "armed":
        from repro_torch.ft import FaultPlan, FaultSpec
        kw = dict(kw, fault_plan=FaultPlan([FaultSpec("newton", 10 ** 6,
                                                      "nan")]))
    if outcome != "runs":
        for odeint_implicit, f, t in (
                (timp.odeint_implicit, _tf, _t),
                (jimp.odeint_implicit, _jf,
                 lambda x: jax.tree_util.tree_map(jnp.asarray, x))):
            with pytest.raises(ValueError, match=outcome):
                odeint_implicit(f, t(u0), t(th), dt=DT, n_steps=N, **kw)
        return
    a = _port_grads(u0, th, "cn", **kw)
    b = _port_grads(u0, th, "cn")
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    if "obs" in kw:
        assert len(kw["obs"].implicit_steps()) == N


def test_mem_budget_without_auto_raises_the_references_value_error():
    u0, th = _problem_np()
    def j(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    for odeint_implicit, f, t in ((timp.odeint_implicit, _tf, _t),
                                  (jimp.odeint_implicit, _jf, j)):
        with pytest.raises(ValueError, match="adjoint='auto'"):
            odeint_implicit(f, t(u0), t(th), dt=DT, n_steps=N,
                            mem_budget=10 ** 6)


@pytest.mark.parametrize("kw", [dict(adjoint="auto"),
                                dict(mem_verify="model")],
                         ids=["auto", "mem_verify"])
def test_auto_without_budget_and_mem_verify_alone_are_pnode(kw):
    u0, th = _problem_np()
    a = _port_grads(u0, th, "cn", **kw)
    b = _port_grads(u0, th, "cn")
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(lanes=True, rescue=True),
                                dict(lanes=True, mass=np.eye(D)),
                                dict(capture=True, rescue=True),
                                dict(capture=True, mass=np.eye(D))],
                         ids=["lanes-rescue", "lanes-mass", "capture-rescue",
                              "capture-mass"])
def test_masked_solver_refuses_rescue_and_mass_naming_item_7c(kw):
    with pytest.raises(NotImplementedError, match="item 7c"):
        timp.ImplicitSolver(_tf, dt=DT, n_steps=N, **kw)


def test_validation_follows_the_reference():
    u0, th = _problem_np()
    for kw, match in ((dict(adjoint="naive"), "impossible"),
                      (dict(adjoint="pnode2"), "unknown implicit adjoint"),
                      (dict(method="rk4"), "unknown implicit method"),
                      (dict(n_steps=0), "n_steps"),
                      (dict(offload="tape"), "unknown offload tier"),
                      (dict(rescue="yes"), "rescue must be"),
                      (dict(adjoint="revolve"), "ncheck")):
        args = dict(dt=DT, n_steps=N)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            timp.odeint_implicit(_tf, _t(u0), _t(th), **args)
    uf = timp.odeint_implicit(_tf, _t(u0), _t(th), dt=DT, n_steps=N,
                              offload="device")
    assert bool(torch.isfinite(uf).all())


def test_a_second_reverse_sweep_raises():
    u0, th = _problem_np()
    u = _t(u0, True)
    uf = timp.odeint_implicit(_tf, u, _t(th), dt=DT, n_steps=N)
    loss = torch.sum(uf ** 2)
    torch.autograd.grad(loss, [u], retain_graph=True)
    with pytest.raises(RuntimeError, match="ran twice"):
        torch.autograd.grad(loss, [u])
