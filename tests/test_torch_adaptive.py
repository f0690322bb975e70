"""The port's adaptive Dopri5 (``repro_torch.core.adaptive``) held against
the JAX package's ``repro.core.adaptive.odeint_adaptive`` on shared fp64
inputs made with numpy from a seed (x64 set on both sides).

- The attempt sequence is the same: every attempt's accept flag exactly
  (JAX's from its flight recorder), hence n_accepted and n_rejected, and
  its (t, h) to rtol 1e-6.  h is not held tighter because the error norm
  that sets it is a difference of stage values some 1e8 times smaller
  than they are, so the stages' last-ulp differences reach it at about
  1e-8 relative (measured 4.9e-8); a controller that differed (its
  exponents, safety factor or clip) would move h by 1e-2 or more.  The problem has a pulse at t = 1 that makes
  the PI controller reject steps in mid-run, and a large h0 that makes it
  reject at the start.
- u_final and the gradients w.r.t. u0 and theta agree at rtol 1e-10 /
  atol 1e-12, the tolerance ``test_torch_core.py`` uses for the same
  contract (XLA and PyTorch sum the matmuls in different orders).
- Inside the port, ``fused_stages`` and capture change no bit; the
  gradient does not depend on ``max_steps`` (the reverse sweep runs over
  the accepted prefix only, ``adjoint_stages * n_accepted`` vjps).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adaptive import odeint_adaptive as j_odeint_adaptive
from repro.core.cnf import exact_trace_vf as j_exact_trace_vf
from repro.models.ode_nets import cnf_vf as j_cnf_vf
from repro.models.ode_nets import cnf_vf_init as j_cnf_vf_init
from repro.obs.trace import FlightRecorder
from repro_torch import convert
from repro_torch.core import adaptive as tad
from repro_torch.core.adjoint import adjoint_stages
from repro_torch.core.cnf import AdaptiveCNF
from repro_torch.kernels import ops
from repro_torch.models.ode_nets import cnf_vf as t_cnf_vf

JAX_RTOL, JAX_ATOL = 1e-10, 1e-12
SEQ_RTOL = 1e-6
D = 6
T1 = 2.0
TOL = 1e-7


@pytest.fixture(autouse=True)
def _x64_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax.enable_x64(True):
        yield
    torch.set_num_threads(prev)


def _problem_np(seed=3):
    rs = np.random.RandomState(seed)
    return rs.randn(D), {"W": 0.6 * rs.randn(D, D), "b": 0.1 * rs.randn(D)}


def _jf(u, th, t):
    return (jnp.tanh(th["W"] @ u + th["b"]) - 0.2 * u
            + 4.0 * jnp.exp(-((t - 1.0) / 0.05) ** 2) * jnp.tanh(u))


def _tf(u, th, t):
    return (torch.tanh(th["W"] @ u + th["b"]) - 0.2 * u
            + 4.0 * torch.exp(-((t - 1.0) / 0.05) ** 2) * torch.tanh(u))


def _t(tree, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.tensor(tree, requires_grad=grad)


def _jax_run(u0, th, **kw):
    """(u_final, grads (u0, W, b), AdaptiveInfo, attempts) of JAX's solve
    and sum(u_final**2)."""
    rec = FlightRecorder()

    def loss(u, p):
        uf, info = j_odeint_adaptive(_jf, u, p, t0=0.0, t1=T1, obs=rec, **kw)
        return jnp.sum(uf ** 2), (uf, info)

    (_, (uf, info)), (gu, gth) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(u0), jax.tree_util.tree_map(jnp.asarray, th))
    attempts = [(float(s["t"]), float(s["h"]), bool(s["accept"]))
                for s in rec.adaptive_steps()]
    return (np.asarray(uf), [np.asarray(gu), np.asarray(gth["W"]),
                             np.asarray(gth["b"])], info, attempts)


class _Recording(tad.AdaptiveSolver):
    """The port's solver, recording each live attempt's (t, h, accept)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attempts = []

    def _attempt(self, record):
        live, n_acc = bool(self._live), int(self._n_acc)
        t = float(self._t)
        h = float(torch.minimum(self._h, self.t1 - self._t))
        super()._attempt(record)
        if live:
            self.attempts.append((t, h, int(self._n_acc) > n_acc))


def _port_run(u0, th, solver_cls=tad.AdaptiveSolver, **kw):
    solver = solver_cls(_tf, t0=0.0, t1=T1, **kw)
    u = _t(u0, grad=True)
    p = _t(th, grad=True)
    uf, info = solver(u, p)
    grads = torch.autograd.grad(torch.sum(uf ** 2), [u, p["W"], p["b"]])
    return uf.detach(), list(grads), info, solver


@pytest.mark.parametrize("h0", [None, 0.5], ids=["h0-default", "h0-large"])
def test_attempt_sequence_matches_jax(h0):
    u0, th = _problem_np()
    _, _, jinfo, j_attempts = _jax_run(u0, th, rtol=TOL, atol=TOL, h0=h0)
    _, _, info, solver = _port_run(u0, th, _Recording, rtol=TOL, atol=TOL,
                                   h0=h0)
    assert (info.n_accepted, info.n_rejected, info.nfe_forward) == (
        int(jinfo.n_accepted), int(jinfo.n_rejected),
        int(jinfo.nfe_forward))
    assert info.n_rejected >= 2          # the sequence exercises rejection
    assert [a[2] for a in solver.attempts] == [a[2] for a in j_attempts]
    np.testing.assert_allclose([a[:2] for a in solver.attempts],
                               [a[:2] for a in j_attempts], rtol=SEQ_RTOL,
                               atol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_solution_and_gradients_match_jax(fused):
    u0, th = _problem_np()
    ju, jg, jinfo, _ = _jax_run(u0, th, rtol=TOL, atol=TOL)
    tu, tg, info, _ = _port_run(u0, th, rtol=TOL, atol=TOL,
                                fused_stages=fused)
    assert info.n_accepted == int(jinfo.n_accepted)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


def test_fused_against_the_reference_fused_kernel():
    """JAX with ``fused_stages=True`` (its Pallas kernel in interpret mode
    on the CPU, as tests/test_hotpath.py runs it) against the port's fused
    solve."""
    u0, th = _problem_np()
    ju, jg, jinfo, _ = _jax_run(u0, th, rtol=1e-5, atol=1e-5,
                                fused_stages=True)
    tu, tg, info, _ = _port_run(u0, th, rtol=1e-5, atol=1e-5,
                                fused_stages=True)
    assert (info.n_accepted, info.n_rejected) == (int(jinfo.n_accepted),
                                                  int(jinfo.n_rejected))
    np.testing.assert_allclose(tu.numpy(), ju, rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


def test_fused_and_captured_are_bitwise_unfused():
    u0, th = _problem_np()
    ref = _port_run(u0, th, rtol=TOL, atol=TOL, h0=0.5)
    for fused in (False, True):
        for capture in (False, True):
            out = _port_run(u0, th, rtol=TOL, atol=TOL, h0=0.5,
                            fused_stages=fused, capture=capture)
            assert out[2] == ref[2]
            assert torch.equal(out[0], ref[0]), (fused, capture)
            for a, b in zip(out[1], ref[1]):
                assert torch.equal(a, b), (fused, capture)


def test_gradient_is_independent_of_max_steps_and_sweeps_accepted_steps(
        monkeypatch):
    u0, th = _problem_np()
    base = _port_run(u0, th, rtol=TOL, atol=TOL)
    n_acc = base[2].n_accepted
    for max_steps in (n_acc, 4 * n_acc, 512):
        out = _port_run(u0, th, rtol=TOL, atol=TOL, max_steps=max_steps)
        assert out[2] == base[2]
        for a, b in zip(out[1], base[1]):
            assert torch.equal(a, b), max_steps
    # reverse NFE: one vjp of f per adjoint stage and accepted step
    u = _t(u0, grad=True)
    uf, info = tad.odeint_adaptive(_tf, u, _t(th), t0=0.0, t1=T1, rtol=TOL,
                                   atol=TOL, max_steps=512)
    seen = []
    orig = torch.func.vjp

    def vjp(fn, *args):
        seen.append(1)
        return orig(fn, *args)

    monkeypatch.setattr(torch.func, "vjp", vjp)
    torch.autograd.grad(torch.sum(uf ** 2), [u])
    assert len(seen) == adjoint_stages("dopri5") * info.n_accepted


def test_gradient_matches_finite_differences():
    """As tests/test_adaptive.py: the discrete adjoint's gradient against
    central differences of the forward solve."""
    u0, th = _problem_np()

    def loss(u):
        uf, _ = tad.odeint_adaptive(_tf, u, _t(th), t0=0.0, t1=1.0,
                                    rtol=1e-9, atol=1e-9)
        return torch.sum(uf ** 2)

    u = _t(u0, grad=True)
    (g,) = torch.autograd.grad(loss(u), [u])
    eps = 1e-6
    with torch.no_grad():
        for i in range(3):
            e = torch.zeros(D, dtype=torch.float64)
            e[i] = eps
            fd = (loss(_t(u0) + e) - loss(_t(u0) - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd), rtol=5e-6)


def test_the_max_steps_cap_stops_where_jax_stops():
    """With the cap binding, the solve ends at t < t1 after max_steps
    accepted steps on both sides.  Its end time is the sum of the step
    sizes, which agree to rtol SEQ_RTOL (module docstring), so u_final and
    the gradients are held there, not at the full solve's 1e-10."""
    u0, th = _problem_np()
    ju, jg, jinfo, _ = _jax_run(u0, th, rtol=TOL, atol=TOL, max_steps=5)
    tu, tg, info, _ = _port_run(u0, th, rtol=TOL, atol=TOL, max_steps=5)
    assert info.n_accepted == int(jinfo.n_accepted) == 5
    assert info.n_rejected == int(jinfo.n_rejected)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=SEQ_RTOL, atol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=SEQ_RTOL,
                                   atol=SEQ_RTOL * np.abs(b).max())


def test_fused_lincomb_calls_match_the_expected_count():
    """``expected_adaptive_lincomb_calls`` against the plain calls one fused
    solve makes on the CPU (a two-leaf state), forward only and with the
    reverse sweep."""
    u0, th = _problem_np()

    def f2(u, p, t):
        a, b = u
        return (_tf(a, p, t), -0.5 * b * torch.cos(t))

    u = (_t(u0, grad=True), torch.tensor([1.0, 2.0], dtype=torch.float64,
                                         requires_grad=True))
    ops.reset_counts()
    with torch.no_grad():
        _, info = tad.odeint_adaptive(f2, u, _t(th), t0=0.0, t1=T1, rtol=TOL,
                                      atol=TOL, h0=0.5, fused_stages=True)
    assert ops.plain_calls == tad.expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2, backward=False)
    assert info.n_rejected > 0
    ops.reset_counts()
    uf, info = tad.odeint_adaptive(f2, u, _t(th), t0=0.0, t1=T1, rtol=TOL,
                                   atol=TOL, h0=0.5, fused_stages=True)
    torch.autograd.grad(sum(torch.sum(x ** 2) for x in uf), list(u))
    assert ops.plain_calls == tad.expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2)
    assert ops.launches == 0


def test_a_stale_reverse_sweep_raises_and_the_solver_is_reusable():
    u0, th = _problem_np()
    solver = tad.AdaptiveSolver(_tf, t0=0.0, t1=T1, rtol=TOL, atol=TOL)
    u1 = _t(u0, grad=True)
    uf1, _ = solver(u1, _t(th))
    u2 = _t(0.5 * u0, grad=True)
    uf2, _ = solver(u2, _t(th))
    with pytest.raises(RuntimeError, match="later forward pass"):
        torch.autograd.grad(torch.sum(uf1 ** 2), [u1])
    (g2,) = torch.autograd.grad(torch.sum(uf2 ** 2), [u2])
    _, (g_fresh, _, _), _, _ = _port_run(0.5 * u0, th, rtol=TOL, atol=TOL)
    assert torch.equal(g2, g_fresh)
    with pytest.raises(ValueError, match="differ in structure"):
        solver(_t(np.zeros(3)), _t(th))


def test_a_call_without_recording_invalidates_the_earlier_reverse_sweep():
    """A forward-only call overwrites the theta buffers that a recorded
    call's reverse sweep reads: that sweep raises instead of
    differentiating the earlier pass with the later weights."""
    u0, th = _problem_np()
    solver = tad.AdaptiveSolver(_tf, t0=0.0, t1=T1, rtol=TOL, atol=TOL)
    u1 = _t(u0, grad=True)
    uf1, _ = solver(u1, _t(th))
    other = {k: 1.5 * v for k, v in th.items()}
    with torch.no_grad():
        solver(_t(u0), _t(other))
    with pytest.raises(RuntimeError, match="later forward pass"):
        torch.autograd.grad(torch.sum(uf1 ** 2), [u1])
    # recorded again, the sweep gives the fresh solver's gradient
    u2 = _t(u0, grad=True)
    uf2, _ = solver(u2, _t(th))
    (g2,) = torch.autograd.grad(torch.sum(uf2 ** 2), [u2])
    _, (g_fresh, _, _), _, _ = _port_run(u0, th, rtol=TOL, atol=TOL)
    assert torch.equal(g2, g_fresh)


#: (keywords, what happens): the ring's spill/disk tiers run; a tier knob
#: without its tier is the reference's ValueError; obs= (a recorder) and
#: fault_plan= (a spec past the last attempt, so the gate is armed but
#: never fires) run bitwise.  The ids are the cases' ids from when every
#: one was refused.
OPTION_CASES = [
    (dict(offload="spill"), "runs"), (dict(offload="disk"), "runs"),
    (dict(offload_segment=4), "offload_segment only applies"),
    (dict(snaps_in_ram=2), "snaps_in_ram is the spill tier"),
    (dict(offload_dir="/nonexistent"), "offload_dir pins"),
    (dict(obs="recorder"), "runs"), (dict(fault_plan="armed"), "runs")]


@pytest.mark.parametrize(
    "kw,outcome", OPTION_CASES,
    ids=[f"kw{i}-item {11 if i >= 5 else 10}" for i in range(7)])
def test_unported_options_raise_naming_their_roadmap_item(kw, outcome):
    u0, th = _problem_np()
    if kw.get("obs") == "recorder":
        from repro_torch.obs import FlightRecorder
        kw = dict(kw, obs=FlightRecorder())
    if kw.get("fault_plan") == "armed":
        from repro_torch.ft import FaultPlan, FaultSpec
        kw = dict(kw, fault_plan=FaultPlan([FaultSpec("adaptive", 10 ** 6,
                                                      "nan")]))
    if outcome != "runs":
        for odeint_adaptive, f, t in (
                (tad.odeint_adaptive, _tf, _t),
                (j_odeint_adaptive, _jf,
                 lambda x: jax.tree_util.tree_map(jnp.asarray, x))):
            with pytest.raises(ValueError, match=outcome):
                odeint_adaptive(f, t(u0), t(th), t0=0.0, t1=1.0, **kw)
        return
    a = _port_run(u0, th, rtol=TOL, atol=TOL, **kw)
    b = _port_run(u0, th, rtol=TOL, atol=TOL)
    assert a[2] == b[2] and torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    if "obs" in kw:
        assert kw["obs"].accepted_rejected() == (a[2].n_accepted,
                                                 a[2].n_rejected)


def test_validation_follows_the_reference():
    u0, th = _problem_np()
    with pytest.raises(ValueError, match="dopri5"):
        tad.odeint_adaptive(_tf, _t(u0), _t(th), t0=0.0, t1=1.0,
                            method="rk4")
    with pytest.raises(ValueError, match="unknown offload tier"):
        tad.odeint_adaptive(_tf, _t(u0), _t(th), t0=0.0, t1=1.0,
                            offload="tape")
    uf, info = tad.odeint_adaptive(_tf, _t(u0), _t(th), t0=0.0, t1=1.0,
                                   offload="device")
    assert info.n_accepted > 0 and bool(torch.isfinite(uf).all())


# ---------------------------------------------------------------------------
# the adaptive CNF request: one point, as the JAX ODEEngine serves it, and
# the batched state (x, logdet); exact trace
# ---------------------------------------------------------------------------

def _jax_cnf_weights(dim):
    """fp64 ``cnf_vf`` weights: the init's plus noise, except the time
    gates' slopes and the time bias, which stay at the init's zeros:
    ``cnf_vf`` rounds t to float32 (the reference's cast), and the two
    solvers' step sizes differ in their last bits (module docstring), which
    that rounding can turn into a float32 ulp of t (6e-8 relative) where a
    slope would read it."""
    jth = j_cnf_vf_init(jax.random.PRNGKey(0), dim, hidden=(8, 8))
    rs = np.random.RandomState(2)
    return {"layers": [
        {k: np.asarray(v, np.float64)
         + (0.0 if k in ("t_gate", "t_bias") else 0.3 * rs.randn(*v.shape))
         for k, v in lyr.items()} for lyr in jth["layers"]]}


@pytest.mark.parametrize("point", [0, 1])
def test_one_point_request_matches_the_jax_engines_adaptive_request(point):
    """``AdaptiveCNF`` on one point (dim,) against the JAX ``ODEEngine``'s
    own compiled adaptive density and score programs (``adaptive=True``:
    each request its own single-lane solve), fp64, at the engine's
    rtol = atol = 1e-6 and 512 steps over t in [0, 1].  One captured
    solver serves both points in turn, as the engine's one compiled
    program does."""
    from repro.serve.engine import ODEEngine
    dim = 3
    jth = _jax_cnf_weights(dim)
    eng = ODEEngine(j_cnf_vf, jth, dim=dim, dt=0.1, n_steps=10,
                    adaptive=True, offload=None)
    tth = convert.params_from_jax(jth, device="cpu")
    cnf = AdaptiveCNF(t_cnf_vf, dim, fused_stages=True, capture=True)
    xs = np.random.RandomState(5).randn(2, dim)
    for i in range(point + 1):
        x = xs[i]
        jd = np.asarray(eng._adaptive_fn("density")(jth, jnp.asarray(x)))
        js = np.asarray(eng._adaptive_fn("score")(jth, jnp.asarray(x)))
        with torch.no_grad():
            density, info = cnf.log_prob(torch.from_numpy(x), tth)
        xg = torch.from_numpy(x).requires_grad_(True)
        lp, info_g = cnf.log_prob(xg, tth)
        (score,) = torch.autograd.grad(lp, xg)
    assert info == info_g and density.shape == () and score.shape == (dim,)
    (_, jinfo) = j_odeint_adaptive(
        j_exact_trace_vf(j_cnf_vf, dim), (jnp.asarray(x), jnp.zeros(())),
        jth, t0=0.0, t1=1.0, rtol=1e-6, atol=1e-6, max_steps=512)
    assert (info.n_accepted, info.n_rejected) == (int(jinfo.n_accepted),
                                                  int(jinfo.n_rejected))
    np.testing.assert_allclose(density.numpy(), jd, rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(score.numpy(), js, rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_adaptive_cnf_density_and_score_match_jax():
    """``AdaptiveCNF`` against JAX's ``odeint_adaptive`` of its exact-trace
    vector field on the same batched state (one step sequence for the
    batch, which the engine does not serve), fp64 weights on both sides
    (``_jax_cnf_weights``), at the engine's rtol = atol = 1e-6."""
    dim, batch = 3, 7
    jth = _jax_cnf_weights(dim)
    x = np.random.RandomState(1).randn(batch, dim)
    aug = j_exact_trace_vf(j_cnf_vf, dim)

    def j_logp(xx):
        (z, dl), info = j_odeint_adaptive(
            aug, (xx, jnp.zeros(batch)), jth, t0=0.0, t1=1.0, rtol=1e-6,
            atol=1e-6, max_steps=512)
        lp = -0.5 * jnp.sum(z ** 2, -1) - 0.5 * dim * jnp.log(2 * jnp.pi) \
            + dl
        return jnp.sum(lp), (lp, info)

    (_, (jlp, jinfo)), jscore = jax.value_and_grad(j_logp, has_aux=True)(
        jnp.asarray(x))
    tth = convert.params_from_jax(jth, device="cpu")
    for fused in (False, True):
        cnf = AdaptiveCNF(t_cnf_vf, dim, fused_stages=fused)
        with torch.no_grad():
            density, info = cnf.log_prob(torch.from_numpy(x), tth)
        xg = torch.from_numpy(x).requires_grad_(True)
        lp, info_g = cnf.log_prob(xg, tth)
        (score,) = torch.autograd.grad(lp.sum(), xg)
        assert info == info_g
        assert (info.n_accepted, info.n_rejected) == (
            int(jinfo.n_accepted), int(jinfo.n_rejected))
        np.testing.assert_allclose(density.numpy(), np.asarray(jlp),
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
        np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
    assert math.isfinite(float(density.sum()))
