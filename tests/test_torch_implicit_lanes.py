"""The port's implicit solver on a lane axis (``ImplicitSolver(lanes=True)``)
and its masked GMRES (``repro_torch.core.gmres.gmres_lanes``), held against
``jax.vmap`` of the JAX package's solvers on shared fp64 inputs made with
numpy from a seed (x64 set on both sides).

- Against JAX at rtol 1e-8 / atol 1e-10 (``tests/test_torch_implicit.py``'s
  tolerance for the same contract): the final states and the gradients
  w.r.t. u0 and theta, with equal per-lane Newton iterations and
  ``diverged``, for the stiff ensemble's kinetics (per-lane
  log-multipliers, ``benchmarks/stiff_ensemble.py``; with the one lane of
  its 1,024-lane sample that exhausts its Newton iterations) and for a
  shared theta (``tests/test_implicit_mem.py``'s field).  The reference is
  jitted: unjitted, its vmapped gradient takes seconds a policy.
- Inside the port, bitwise: pnode == revolve == revolve2 with lanes; a
  lane that converges in few Newton iterations next to one that needs
  many is its solo solve; a permutation of the lanes permutes the results.
- The masked GMRES on one lane is ``gmres`` bit for bit, with equal cycle
  and Arnoldi counts; on several lanes it matches
  ``jax.vmap(jax.scipy.sparse.linalg.gmres(solve_method="incremental"))``
  in its solution (to 1e-10 of max|x|) and each lane's matvec count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import gmres as jgmres

from repro.core import implicit as jimp
from repro_torch.core import implicit as timp
from repro_torch.core.gmres import gmres as tgmres
from repro_torch.core.gmres import gmres_lanes

JAX_RTOL, JAX_ATOL = 1e-8, 1e-10
K_BASE = (0.04, 3.0e7, 1.0e4)
ENS = dict(newton_iters=16, newton_tol=1e-10, gmres_iters=5, gmres_tol=1e-12)
DT, N = 0.01, 6


@pytest.fixture(autouse=True)
def _x64_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax.enable_x64(True):
        yield
    torch.set_num_threads(prev)


def _jrob(u, c, t):
    k1, k2, k3 = (b * jnp.exp(ci) for b, ci in zip(K_BASE, c))
    du1 = -k1 * u[0] + k3 * u[1] * u[2]
    du3 = k2 * u[1] ** 2
    return jnp.stack([du1, -du1 - du3, du3])


def _trob(u, c, t):
    k1, k2, k3 = (b * torch.exp(c[:, i]) for i, b in enumerate(K_BASE))
    du1 = -k1 * u[:, 0] + k3 * u[:, 1] * u[:, 2]
    du3 = k2 * u[:, 1] ** 2
    return torch.stack([du1, -du1 - du3, du3], dim=-1)


def _ensemble(lanes, seed=0):
    """u0 = [1, 0, 0] and c = 0.2 N(0, 1) per lane, as the ensemble."""
    c = 0.2 * np.random.RandomState(seed).randn(lanes, 3)
    return np.tile([1.0, 0.0, 0.0], (lanes, 1)), c


def _port(f, u0, th, *, dt=DT, n_steps=N, **kw):
    """(u_final, [grad u0, grad theta], stats) of sum(u_final**2) through
    ``ImplicitSolver(lanes=True)``."""
    u = torch.tensor(u0, requires_grad=True)
    p = torch.tensor(th, requires_grad=True)
    solver = timp.ImplicitSolver(f, dt=dt, n_steps=n_steps, lanes=True,
                                 **kw)
    uf, st = solver(u, p)
    g = torch.autograd.grad((uf ** 2).sum(), [u, p])
    return uf.detach(), list(g), st


def _check_against_jax(port, jax_out):
    uf, g, st = port
    (juf, jst), (jgu, jgth) = jax_out
    np.testing.assert_array_equal(st.newton_iters.numpy(),
                                  np.asarray(jst.newton_iters))
    np.testing.assert_array_equal(st.diverged.numpy(),
                                  np.asarray(jst.diverged))
    np.testing.assert_allclose(uf.numpy(), np.asarray(juf), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    for a, b in zip(g, (jgu, jgth)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


def test_ensemble_lanes_match_jax_vmap():
    """8 ensemble systems, CN pnode, 6 steps: per-lane c."""
    u0, c = _ensemble(8)

    def loss(u, cc):
        uf, st = jax.vmap(lambda a, b: jimp.odeint_implicit(
            _jrob, a, b, dt=DT, n_steps=N, method="cn", return_stats=True,
            **ENS))(u, cc)
        return jnp.sum(uf ** 2), (uf, st)

    (_, aux), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(u0), jnp.asarray(c))
    port = _port(_trob, u0, c, method="cn", **ENS)
    _check_against_jax(port, (aux, grads))
    assert not bool(port[2].diverged.any())
    # the lanes really exit at different Newton iterations
    assert len(set(port[2].newton_iters.tolist())) > 1


def test_the_ensembles_stiff_lane_diverges_as_in_the_reference():
    """Lane 164 of the ensemble's sample (numpy seed 0, 1,024 lanes, 30
    steps of 0.01) exhausts its 16 Newton iterations at c_true in the
    reference as in the port: equal diverged flags, iterations and
    residuals; its neighbours converge."""
    u0 = np.tile([1.0, 0.0, 0.0], (4, 1))
    c = 0.2 * np.random.RandomState(0).randn(1024, 3)[162:166]
    kw = dict(dt=DT, n_steps=30, method="cn")
    juf, jst = jax.jit(jax.vmap(lambda a, b: jimp.odeint_implicit(
        _jrob, a, b, return_stats=True, **kw, **ENS)))(jnp.asarray(u0),
                                                       jnp.asarray(c))
    with torch.no_grad():
        uf, st = timp.ImplicitSolver(_trob, lanes=True, **kw, **ENS)(
            torch.tensor(u0), torch.tensor(c))
    assert st.diverged.tolist() == [False, False, True, False]
    np.testing.assert_array_equal(st.diverged.numpy(),
                                  np.asarray(jst.diverged))
    np.testing.assert_array_equal(st.newton_iters.numpy(),
                                  np.asarray(jst.newton_iters))
    np.testing.assert_allclose(st.max_residual.numpy(),
                               np.asarray(jst.max_residual), rtol=1e-6)
    np.testing.assert_allclose(uf.numpy(), np.asarray(juf), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_shared_theta_lanes_match_jax_vmap():
    """5 lanes of tanh(th @ u) - 0.5 u with one theta (summed gradient),
    as ``tests/test_implicit_mem.py``'s vmapped solve."""
    rs = np.random.RandomState(2)
    u0, th = rs.randn(5, 4), 0.4 * rs.randn(4, 4)
    kw = dict(dt=0.2, n_steps=7, method="cn", newton_iters=8)

    def loss(u, t):
        uf, st = jax.vmap(lambda a: jimp.odeint_implicit(
            lambda x, p, tt: jnp.tanh(p @ x) - 0.5 * x, a, t,
            return_stats=True, **kw))(u)
        return jnp.sum(uf ** 2), (uf, st)

    (_, aux), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(u0), jnp.asarray(th))
    port = _port(lambda x, p, t: torch.tanh(x @ p.T) - 0.5 * x, u0, th, **kw)
    _check_against_jax(port, (aux, grads))


def test_lane_policies_are_bitwise_equal():
    u0, c = _ensemble(4, seed=1)
    anchor = _port(_trob, u0, c, method="cn", n_steps=4, **ENS)
    for policy, ncheck in (("revolve", 1), ("revolve2", 2)):
        out = _port(_trob, u0, c, method="cn", n_steps=4, adjoint=policy,
                    ncheck=ncheck, **ENS)
        assert torch.equal(out[0], anchor[0])
        assert all(torch.equal(a, b) for a, b in zip(out[1], anchor[1]))
        assert all(torch.equal(a, b) for a, b in zip(out[2], anchor[2]))


def test_fast_lane_next_to_a_slow_lane_is_its_solo_solve():
    """Slow rates (few Newton iterations) beside fast ones (many): each
    lane of the pair is bitwise its own one-lane solve."""
    u0 = np.tile([1.0, 0.0, 0.0], (2, 1))
    c = np.array([[-3.0, -3.0, -3.0], [0.6, 0.6, 0.6]])
    pair = _port(_trob, u0, c, method="cn", n_steps=4, **ENS)
    iters = pair[2].newton_iters.tolist()
    assert iters[1] >= iters[0] + 10, iters
    for i in range(2):
        solo = _port(_trob, u0[i:i + 1], c[i:i + 1], method="cn",
                     n_steps=4, **ENS)
        assert torch.equal(solo[0][0], pair[0][i])
        assert all(torch.equal(a[0], b[i]) for a, b in zip(solo[1], pair[1]))
        assert int(solo[2].newton_iters[0]) == iters[i]


def test_lane_permutation_permutes_the_results_bitwise():
    u0, c = _ensemble(6, seed=3)
    base = _port(_trob, u0, c, method="cn", n_steps=4, **ENS)
    perm = np.random.RandomState(4).permutation(6)
    out = _port(_trob, u0[perm], c[perm], method="cn", n_steps=4, **ENS)
    assert torch.equal(out[0], base[0][perm])
    assert all(torch.equal(a, b[perm]) for a, b in zip(out[1], base[1]))
    assert torch.equal(out[2].newton_iters, base[2].newton_iters[perm])


# ---------------------------------------------------------------------------
# the masked GMRES
# ---------------------------------------------------------------------------

def _matrices(lanes, n, seed):
    rs = np.random.RandomState(seed)
    m = np.eye(n) + 0.6 * rs.randn(lanes, n, n) / np.sqrt(n)
    return m, rs.randn(lanes, n)


@pytest.mark.parametrize("kw", [dict(tol=1e-10),
                                dict(tol=1e-10, restart=3, maxiter=30),
                                dict(tol=1e-10, restart=3, maxiter=2)],
                         ids=["one-cycle", "restart3", "maxiter2"])
def test_masked_gmres_on_one_lane_is_bitwise_gmres(kw):
    m, b = _matrices(1, 9, 5)
    mt = torch.from_numpy(m[0])

    def A(w):   # the operator gmres applies, on the one lane
        return (mt @ w[0])[None]

    masked = gmres_lanes(A, torch.from_numpy(b), **kw)
    exits = gmres_lanes(A, torch.from_numpy(b), host_exits=True, **kw)
    x, info = tgmres(lambda v: mt @ v, torch.from_numpy(b[0]), **kw)
    assert torch.equal(masked.x[0], x) and int(masked.info[0]) == int(info)
    assert torch.equal(masked.cycles, exits.cycles)
    assert torch.equal(masked.steps, exits.steps)
    assert int(masked.steps[0]) > 0


def test_masked_gmres_lanes_match_jax_vmap():
    """Three systems with restart 3: the lanes take different numbers of
    cycles; each lane's matvecs (1 + cycles + Arnoldi steps) equal JAX's
    count for that system, and the solutions agree."""
    m, b = _matrices(3, 8, 6)
    m[0] = np.eye(8) + 0.05 * m[0]          # a lane that converges fast
    kw = dict(tol=1e-10, restart=3, maxiter=40)
    mt = torch.from_numpy(m)
    res = gmres_lanes(lambda w: (mt @ w[:, :, None])[:, :, 0],
                      torch.from_numpy(b), **kw)
    jx = jax.vmap(lambda mm, bb: jgmres(lambda v: mm @ v, bb,
                                        solve_method="incremental", **kw)[0])(
        jnp.asarray(m), jnp.asarray(b))
    jx = np.asarray(jx)
    np.testing.assert_allclose(res.x.numpy(), jx, rtol=0,
                               atol=1e-10 * np.abs(jx).max())
    for i in range(3):
        count = [0]

        def tick(_v):
            count[0] += 1

        def matvec(v, mm=jnp.asarray(m[i])):
            jax.debug.callback(tick, v)
            return mm @ v

        jgmres(matvec, jnp.asarray(b[i]), solve_method="incremental", **kw)
        jax.effects_barrier()
        assert count[0] == 1 + int(res.cycles[i]) + int(res.steps[i]), i
    assert len(set(res.cycles.tolist())) > 1
