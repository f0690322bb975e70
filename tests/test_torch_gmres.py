"""The port's GMRES (``repro_torch.core.gmres``) held against
``jax.scipy.sparse.linalg.gmres(solve_method="incremental")``, the solver
the JAX package's implicit integrators call, on shared fp64 systems made
with numpy from a seed.

Both sides count their matrix-vector products (JAX's through a
``jax.debug.callback`` on the product's operand, which runs once per
execution): equal counts mean equal restart cycles and equal inner
iterations, so a Newton solve built on either exits alike.  Solutions
agree to rtol 1e-12 of max|x|: the two sum their dot products in different
orders, and the conditioning amplifies those ulps.

Systems: well conditioned (I plus a scaled Gaussian, condition number
about 3) and ill conditioned (symmetric positive definite, and
non-normal with a well-conditioned eigenbasis, singular values or
eigenvalues spread log-uniformly up to 1e3-1e4).  Each case held for
seeds 0-5 when the grid was chosen; two of them run here.  Beyond it, at
condition 1e6 or where short restarted cycles stall on an ill-conditioned
system, two solvers that sum in different orders still agree in their
counts, but not to 1e-12: the conditioning amplifies the rounding
(measured up to 2.5e-10 at n = 8, condition 1e4-1e6, and 1.9e-12 for the
SPD n = 32 system in two 5-step cycles), so such systems are not used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import gmres as jgmres

from repro_torch.core.gmres import gmres as tgmres

SOL_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _system(kind, n, cond, seed):
    """An n x n system and a right-hand side: "well" (I + 0.5 G / sqrt(n)),
    "spd" (Q diag(logspace(0, log10 cond)) Q^T) or "nonnormal"
    (V diag(logspace(...)) V^-1 with V = I + 0.2 G / sqrt(n))."""
    rs = np.random.RandomState(seed)
    if kind == "well":
        m = np.eye(n) + 0.5 * rs.randn(n, n) / np.sqrt(n)
    elif kind == "spd":
        q, _ = np.linalg.qr(rs.randn(n, n))
        m = q @ np.diag(np.logspace(0, np.log10(cond), n)) @ q.T
    else:
        v = np.eye(n) + 0.2 * rs.randn(n, n) / np.sqrt(n)
        m = v @ np.diag(np.logspace(0, np.log10(cond), n)) @ np.linalg.inv(v)
    return m, rs.randn(n)


def _jax_solve(m, b, **kw):
    count = [0]

    def tick(_v):
        count[0] += 1

    def matvec(v):
        jax.debug.callback(tick, v)
        return jnp.asarray(m) @ v

    x, _ = jgmres(matvec, jnp.asarray(b), solve_method="incremental", **kw)
    x = np.asarray(x)
    jax.effects_barrier()
    return x, count[0]


def _port_solve(m, b, **kw):
    count = [0]
    mt = torch.from_numpy(m)

    def matvec(v):
        count[0] += 1
        return mt @ v

    x, info = tgmres(matvec, torch.from_numpy(b), **kw)
    assert int(info) == 0
    return x.numpy(), count[0]


def _check(m, b, kw):
    xj, nj = _jax_solve(m, b, **kw)
    xt, nt = _port_solve(m, b, **kw)
    assert nt == nj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=SOL_RTOL * np.abs(xj).max())


@pytest.mark.parametrize("n", [8, 32, 64])
@pytest.mark.parametrize("kw", [
    dict(tol=1e-10),                              # one cycle (restart 20)
    dict(tol=1e-10, restart=5, maxiter=40),       # many short cycles
    dict(tol=1e-10, restart=5, maxiter=2),        # the cycle cap binds
], ids=["default", "restart5", "maxiter2"])
def test_gmres_matches_jax_well_conditioned(n, kw):
    for seed in range(2):
        _check(*_system("well", n, None, seed), kw)


ONE_CYCLE = dict(tol=1e-10, restart=64)        # restart capped at n
TWO_CYCLES = dict(tol=1e-10, restart=5, maxiter=2)


@pytest.mark.parametrize("kind,n,cond,kw", [
    ("spd", 32, 1e4, ONE_CYCLE), ("spd", 64, 1e4, ONE_CYCLE),
    ("spd", 64, 1e4, TWO_CYCLES),
    ("nonnormal", 32, 1e3, TWO_CYCLES), ("nonnormal", 64, 1e3, TWO_CYCLES)],
    ids=["spd32-one", "spd64-one", "spd64-two",
         "nonnormal32-two", "nonnormal64-two"])
def test_gmres_matches_jax_ill_conditioned(kind, n, cond, kw):
    for seed in range(2):
        _check(*_system(kind, n, cond, seed), kw)


def test_gmres_on_a_pytree_and_a_zero_rhs():
    """A dict of leaves is solved as one flattened vector (a block-diagonal
    operator couples nothing, so each block equals its own solve); b = 0
    returns x = 0 with no cycle run."""
    m1, b1 = _system("well", 5, None, 7)
    m2, b2 = _system("well", 3, None, 8)
    t1, t2 = torch.from_numpy(m1), torch.from_numpy(m2)
    b = {"a": torch.from_numpy(b1), "c": torch.from_numpy(b2).reshape(3, 1)}
    x, _ = tgmres(lambda v: {"a": t1 @ v["a"], "c": t2 @ v["c"]}, b,
                  tol=1e-12)
    np.testing.assert_allclose(x["a"].numpy(), np.linalg.solve(m1, b1),
                               rtol=1e-10)
    np.testing.assert_allclose(x["c"].numpy()[:, 0], np.linalg.solve(m2, b2),
                               rtol=1e-10)
    calls = [0]

    def matvec(v):
        calls[0] += 1
        return t1 @ v

    x0, info = tgmres(matvec, torch.zeros(5, dtype=torch.float64))
    assert calls[0] == 1 and int(info) == 0
    assert torch.equal(x0, torch.zeros(5, dtype=torch.float64))
