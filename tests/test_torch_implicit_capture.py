"""The implicit solver's masked units on the CPU: ``ImplicitSolver(capture=
True)`` runs the same functions as the card's CUDA graphs, eagerly, on the
same static buffers (``launch.graphs.StepGraph``'s CPU behaviour), so it
is held bitwise against the eager route (host-read exits), here in fp64:

- states, gradients and ``ImplicitStats`` for beuler and CN under every
  policy;
- the host reads: the ``live`` flag once every ``CHECK_EVERY`` units and
  the stats once a solve, nothing else;
- the stiff Robertson example's 19-solve CN loss and its Dopri5 loss
  (one captured solver an interval), value and gradient;
- the refusals: a reverse sweep after a later forward pass, a second
  reverse sweep, another layout.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.adaptive import CHECK_EVERY
from repro_torch.core import implicit as timp

D, DT, N = 5, 0.2, 5
POLICIES = [("pnode", None), ("revolve", 2), ("revolve2", 2)]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _f(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u \
        + 0.1 * torch.sin(torch.as_tensor(t, dtype=u.dtype)) * u


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    u0 = torch.tensor(rs.randn(D), requires_grad=True)
    th = {"W": torch.tensor(0.5 * rs.randn(D, D), requires_grad=True),
          "b": torch.tensor(0.1 * rs.randn(D), requires_grad=True)}
    return u0, th


def _grads(solver, seed=1):
    u0, th = _inputs(seed)
    uf, st = solver(u0, th)
    g = torch.autograd.grad((uf ** 2).sum(), [u0, th["W"], th["b"]])
    return [uf.detach()] + list(g), st


@pytest.mark.parametrize("method", ["beuler", "cn"])
@pytest.mark.parametrize("policy,ncheck", POLICIES,
                         ids=[p for p, _ in POLICIES])
def test_captured_solver_on_the_cpu_is_bitwise_the_eager_route(method,
                                                               policy,
                                                               ncheck):
    kw = dict(dt=DT, n_steps=3, method=method, adjoint=policy, ncheck=ncheck)
    eager, st_e = _grads(timp.ImplicitSolver(_f, **kw))
    solver = timp.ImplicitSolver(_f, capture=True, **kw)
    for _ in range(2):   # a second call runs on the same static buffers
        cap, st_c = _grads(solver)
        assert st_c == st_e and not st_c.diverged
        assert all(torch.equal(a, b) for a, b in zip(cap, eager))
    # the functional entry is the eager route
    u0, th = _inputs()
    uf, st = timp.odeint_implicit(_f, u0, th, return_stats=True, **kw)
    assert torch.equal(uf.detach(), eager[0]) and st == st_e


def test_captured_solve_reads_only_the_live_flag_and_the_stats():
    solver = timp.ImplicitSolver(_f, dt=DT, n_steps=N, capture=True)
    _grads(solver)
    assert solver.replays > 0
    assert solver.live_reads * CHECK_EVERY == solver.replays
    assert solver.stats_reads == 1
    with torch.no_grad():
        u0, th = _inputs()
        uf, st = solver(u0, th)
    assert solver.live_reads * CHECK_EVERY == solver.replays
    assert solver.stats_reads == 2 and not st.diverged


def test_starved_newton_surfaces_diverged_in_the_masked_units():
    kw = dict(dt=DT, n_steps=N, newton_iters=1, newton_tol=1e-16)
    eager, st_e = _grads(timp.ImplicitSolver(_f, **kw))
    cap, st_c = _grads(timp.ImplicitSolver(_f, capture=True, **kw))
    assert st_e.diverged and st_c == st_e and st_c.newton_iters == N
    assert all(torch.equal(a, b) for a, b in zip(cap, eager))


def test_robertson_losses_captured_bitwise_eager_on_the_cpu():
    """The example's CN loss (19 ``ImplicitSolver``s) and Dopri5 loss (19
    ``AdaptiveSolver``s), captured against eager, on a seeded target."""
    from repro_torch.examples import stiff_robertson as trob
    y0, target = trob.scaled_data(np.random.RandomState(0).rand(20, 3), "cpu")
    theta = trob.mlp_vf_init(torch.Generator().manual_seed(0), 3, hidden=32,
                             n_hidden=3, device="cpu")
    out = {}
    for capture in (False, True):
        stats: list = []
        losses = trob.make_losses(y0, target, cn_stats=stats,
                                  capture=capture)
        for name in ("cn", "dopri"):
            loss, g = trob.value_and_grad(getattr(losses, name), theta)
            out[capture, name] = [loss] + pytree.tree_leaves(g)
        out[capture, "stats"] = stats
        if capture:
            assert all(s.live_reads * CHECK_EVERY == s.replays > 0
                       for s in losses.cn_solvers)
    assert out[True, "stats"] == out[False, "stats"]
    assert not any(s.diverged for s in out[True, "stats"])
    for name in ("cn", "dopri"):
        assert all(torch.equal(a, b) for a, b in
                   zip(out[True, name], out[False, name])), name


def test_reverse_sweep_after_a_later_forward_raises():
    solver = timp.ImplicitSolver(_f, dt=DT, n_steps=2, capture=True)
    u1, th = _inputs(1)
    u2, _ = _inputs(2)
    uf1, _ = solver(u1, th)
    uf2, _ = solver(u2, th)
    with pytest.raises(RuntimeError, match="later forward pass"):
        torch.autograd.grad(uf1.sum(), [u1])
    loss = uf2.sum()
    torch.autograd.grad(loss, [u2], retain_graph=True)
    with pytest.raises(RuntimeError, match="ran twice"):
        torch.autograd.grad(loss, [u2])


def test_solver_refuses_another_layout():
    solver = timp.ImplicitSolver(_f, dt=DT, n_steps=2, capture=True)
    u0, th = _inputs()
    solver(u0, th)
    with pytest.raises(ValueError, match="build a new solver"):
        solver(u0.detach().float(), th)
