"""The port's integrators, revolve schedules and adjoint policies held
against the JAX package on shared fp64 inputs (made with numpy from a seed).

Tolerances: a policy against the port's own ``naive`` uses the reference's
rtol 1e-12 / atol 1e-13 (tests/test_reverse_accuracy.py).  Port against
JAX uses rtol 1e-10 / atol 1e-12: XLA and PyTorch's CPU kernels sum the
matmuls in different orders, so the two agree to a few ulps per op, not
bitwise; the gap compounds over the steps of a solve.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import integrators as jint
from repro.core import revolve as jrev
from repro_torch.core import adjoint as tadj
from repro_torch.core import integrators as tint
from repro_torch.core import revolve as trev
from repro_torch.core.tableaus import EXPLICIT_TABLEAUS, get_tableau
from repro_torch.kernels import ops

jax.config.update("jax_enable_x64", True)

D = 6
HORIZON = 0.6
TABLEAUS = sorted(EXPLICIT_TABLEAUS)
POL_RTOL, POL_ATOL = 1e-12, 1e-13
JAX_RTOL, JAX_ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problem_np(seed=7):
    rs = np.random.RandomState(seed)
    u0 = rs.randn(D)
    th = {"W": 0.4 * rs.randn(D, D), "b": 0.1 * rs.randn(D)}
    return u0, th


def _jf(u, th, t):
    return jnp.tanh(th["W"] @ u + th["b"]) - 0.2 * u + 0.05 * jnp.cos(t) * u


def _tf(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.2 * u \
        + 0.05 * math.cos(t) * u


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _port_grads(policy, *, method="rk4", n_steps=12, dt=HORIZON / 12, **kw):
    u0n, thn = _problem_np()
    u0 = _t(u0n, True)
    th = {k: _t(v, True) for k, v in thn.items()}
    uf = tadj.odeint(_tf, u0, th, dt=dt, n_steps=n_steps, method=method,
                     adjoint=policy, **kw)
    gu, gw, gb = torch.autograd.grad((uf ** 2).sum(), [u0, th["W"], th["b"]])
    return {"u0": gu.numpy(), "W": gw.numpy(), "b": gb.numpy()}


def _jax_grads(policy, *, method="rk4", n_steps=12, dt=HORIZON / 12, **kw):
    u0n, thn = _problem_np()

    def loss(u0_, th_):
        uf = jadj.odeint(_jf, u0_, th_, dt=dt, n_steps=n_steps,
                         method=method, adjoint=policy, **kw)
        return jnp.sum(uf ** 2)

    gu, gth = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(u0n), {k: jnp.asarray(v) for k, v in thn.items()})
    return {"u0": np.asarray(gu), "W": np.asarray(gth["W"]),
            "b": np.asarray(gth["b"])}


def _close(a, b, rtol, atol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# one step forward and one adjoint step, every explicit tableau, fp64 vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", TABLEAUS)
def test_step_and_adjoint_step_match_jax(method):
    u0n, thn = _problem_np()
    lam_n = np.random.RandomState(3).randn(D)
    t, h = 0.3, 0.07
    jtab, ttab = jint.get_tableau(method), get_tableau(method)
    np.testing.assert_array_equal(jtab.a, ttab.a)
    jth = {k: jnp.asarray(v) for k, v in thn.items()}
    tth = {k: _t(v) for k, v in thn.items()}

    ju, jst = jint.rk_step(_jf, jtab, jnp.asarray(u0n), jth, t, h)
    tu, tst = tint.rk_step(_tf, ttab, _t(u0n), tth, t, h)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=JAX_RTOL,
                               atol=JAX_ATOL)

    jl, jg = jint.rk_adjoint_step(_jf, jtab, jnp.asarray(u0n), jst, jth, t,
                                  h, jnp.asarray(lam_n))
    for fused in (False, True):
        tl, tg = tint.rk_adjoint_step(_tf, ttab, _t(u0n), tst, tth, t, h,
                                      _t(lam_n), fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        for k in thn:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=JAX_RTOL, atol=JAX_ATOL)


def test_solve_fixed_trajectory_matches_jax():
    u0n, thn = _problem_np()
    jth = {k: jnp.asarray(v) for k, v in thn.items()}
    tth = {k: _t(v) for k, v in thn.items()}
    ju, jtraj = jint.solve_fixed_trajectory(_jf, "bosh3", jnp.asarray(u0n),
                                            jth, 0.1, 0.05, 5)
    tu, ttraj = tint.solve_fixed_trajectory(_tf, "bosh3", _t(u0n), tth,
                                            0.1, 0.05, 5)
    assert ttraj.shape == (5, D)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj),
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_array_equal(ttraj[-1].numpy(), tu.numpy())


# ---------------------------------------------------------------------------
# revolve schedules: the copy must decide exactly what the reference does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_t", [2, 3, 5, 8, 13, 21, 40])
def test_revolve_schedules_identical(n_t):
    for n_c in range(1, min(n_t, 7)):
        assert trev.sweep_checkpoint_positions(n_t, n_c) == \
            jrev.sweep_checkpoint_positions(n_t, n_c)
        assert trev.reverse_schedule(n_t, n_c) == \
            jrev.reverse_schedule(n_t, n_c)
        assert trev.optimal_extra_steps(n_t, n_c) == \
            jrev.optimal_extra_steps(n_t, n_c)
        assert trev.prop2_optimal_extra_steps(n_t, n_c) == \
            jrev.prop2_optimal_extra_steps(n_t, n_c)


# ---------------------------------------------------------------------------
# reverse accuracy inside the port (the reference's own contract)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy",
                         [p for p in tadj.POLICIES if p != "continuous"])
def test_port_policy_reverse_accurate(policy):
    kw = {"ncheck": 3} if policy.startswith("revolve") else {}
    _close(_port_grads(policy, **kw), _port_grads("naive"),
           POL_RTOL, POL_ATOL)


def test_port_continuous_adjoint_o_h2_per_step():
    """Prop. 1: halving dt at fixed horizon shrinks the continuous
    adjoint's per-step gap ~4x; pnode stays at roundoff."""
    def gap(policy, n):
        a = _port_grads(policy, method="euler", n_steps=n, dt=HORIZON / n)
        b = _port_grads("naive", method="euler", n_steps=n, dt=HORIZON / n)
        return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)

    ns = (8, 16, 32, 64)
    per_step = [gap("continuous", n) / n for n in ns]
    assert per_step[0] * ns[0] > 1e-9
    for a, b in zip(per_step, per_step[1:]):
        assert a / b > 2.8, per_step
    for n in (ns[0], ns[-1]):
        assert gap("pnode", n) < 1e-10


# ---------------------------------------------------------------------------
# port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", tadj.POLICIES)
def test_policy_grads_match_jax_rk4(policy):
    kw = {"ncheck": 3} if policy.startswith("revolve") else {}
    _close(_port_grads(policy, **kw), _jax_grads(policy, **kw),
           JAX_RTOL, JAX_ATOL)


@pytest.mark.parametrize("method", TABLEAUS)
def test_pnode_grads_match_jax_every_tableau(method):
    _close(_port_grads("pnode", method=method, fused_stages=True),
           _jax_grads("pnode", method=method), JAX_RTOL, JAX_ATOL)


@pytest.mark.parametrize("policy,kw", [("pnode", {}), ("pnode2", {}),
                                       ("revolve", {"ncheck": 3}),
                                       ("revolve2", {"ncheck": 3})])
def test_fused_grads_bitwise_unfused(policy, kw):
    a = _port_grads(policy, fused_stages=True, **kw)
    b = _port_grads(policy, **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("policy", ["naive", "continuous", "anode", "aca"])
def test_fused_stages_rejected_for_lowlevel_policies(policy):
    with pytest.raises(ValueError, match="fused_stages"):
        _port_grads(policy, fused_stages=True)


@pytest.mark.parametrize("bad", [None, 0, 12])
def test_ncheck_validated(bad):
    with pytest.raises(ValueError, match="ncheck"):
        _port_grads("revolve", ncheck=bad)


def test_quadrature_matches_jax():
    u0n, thn = _problem_np()

    def jq(u, th, t):
        return jnp.sum(u ** 2)

    def tq(u, th, t):
        return torch.sum(u ** 2)

    def jloss(u0_, th_):
        uf, Q = jadj.odeint_with_quadrature(_jf, jq, u0_, th_, dt=0.05,
                                            n_steps=6, adjoint="revolve",
                                            ncheck=2)
        return jnp.sum(uf) + Q

    jg = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(u0n), {k: jnp.asarray(v) for k, v in thn.items()})
    u0 = _t(u0n, True)
    th = {k: _t(v, True) for k, v in thn.items()}
    uf, Q = tadj.odeint_with_quadrature(_tf, tq, u0, th, dt=0.05, n_steps=6,
                                        adjoint="revolve", ncheck=2,
                                        fused_stages=True)
    tg = torch.autograd.grad(uf.sum() + Q, [u0, th["W"], th["b"]])
    for a, b in zip(tg, [jg[0], jg[1]["W"], jg[1]["b"]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


# ---------------------------------------------------------------------------
# analytic accounting
# ---------------------------------------------------------------------------

def test_nfe_and_checkpoint_accounting_equal_reference():
    for method in TABLEAUS:
        assert tadj.adjoint_stages(method) == jadj.adjoint_stages(method)
        for n in (3, 7, 16):
            assert tadj.nfe_forward(method, n) == jadj.nfe_forward(method, n)
            for pol in tadj.POLICIES:
                for nc in ((1, 2) if pol.startswith("revolve") else (None,)):
                    assert tadj.nfe_backward(method, n, pol, nc) == \
                        jadj.nfe_backward(method, n, pol, nc)
                    assert tadj.checkpoint_floats(method, n, pol, 5, nc) == \
                        jadj.checkpoint_floats(method, n, pol, 5, nc)


def test_nfe_counted_matches_formula():
    """Counted f evaluations of a pnode gradient = NFE-F + NFE-B."""
    count = {"n": 0}

    def f(u, th, t):
        count["n"] += 1
        return _tf(u, th, t)

    u0n, thn = _problem_np()
    for method in ("euler", "rk4", "dopri5"):
        u0 = _t(u0n, True)
        th = {k: _t(v, True) for k, v in thn.items()}
        count["n"] = 0
        uf = tadj.odeint(f, u0, th, dt=0.05, n_steps=7, method=method)
        torch.autograd.grad((uf ** 2).sum(), [u0, th["W"]])
        assert count["n"] == tadj.nfe_forward(method, 7) \
            + tadj.nfe_backward(method, 7, "pnode")


@pytest.mark.parametrize("method", TABLEAUS)
@pytest.mark.parametrize("policy,ncheck", [("pnode", None), ("pnode2", None),
                                           ("revolve", 3), ("revolve2", 3)])
def test_expected_lincomb_calls_equal_plain_calls(method, policy, ncheck):
    """The helper chip_smoke.py uses to check launches on the card, held
    against the counter of the plain version on the CPU (two leaves)."""
    n_steps = 5
    u0 = (_t(np.arange(3.0), True), _t(np.ones(2), True))
    th = {"a": _t(0.3, True)}

    def f(u, th, t):
        return (-th["a"] * u[0], th["a"] * u[1] * t)

    ops.reset_counts()
    out = tadj.odeint(f, u0, th, dt=0.1, n_steps=n_steps, method=method,
                      adjoint=policy, ncheck=ncheck, fused_stages=True)
    assert ops.plain_calls == tadj.expected_lincomb_calls(
        method, n_steps, 2, policy, ncheck, backward=False)
    torch.autograd.grad(out[0].sum() + out[1].sum(), [u0[0], th["a"]])
    assert ops.plain_calls == tadj.expected_lincomb_calls(
        method, n_steps, 2, policy, ncheck)
    assert ops.launches == 0


def test_expected_lincomb_calls_rk4_example():
    assert tadj.expected_lincomb_calls("rk4", 4, 1, "pnode") == 40
    with pytest.raises(ValueError):
        tadj.expected_lincomb_calls("rk4", 4, 1, "aca")
