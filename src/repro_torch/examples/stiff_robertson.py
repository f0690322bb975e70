"""Paper §5.3: learning Robertson's stiff chemical kinetics with an
implicit Crank-Nicolson integrator and its discrete adjoint (the capability
PNODE uniquely enables) vs adaptive explicit Dopri5.  The port's
counterpart of the JAX package's ``examples/stiff_robertson.py``, in fp64
as that one runs (``jax_enable_x64``): the states and the trajectory are
fp64, the MLP's weights fp32, promoted where they meet the state.

  PYTHONPATH=src python -m repro_torch.examples.stiff_robertson \
      [--epochs 200] [--device cuda|cpu] [--mem-budget BYTES]

Expected: CN trains stably to low loss; Dopri5's gradient norm is orders of
magnitude larger / the step count explodes as the learned model stiffens
(paper Fig. 5 and Table 8).  Each of the 19 observation intervals has its
own solver, kept across epochs: an ``ImplicitSolver`` for CN and an
``AdaptiveSolver`` for Dopri5, each captured as CUDA graphs on the card
(``capture=False`` in ``run`` runs the same losses eagerly, with bitwise
equal results).

With ``--mem-budget BYTES`` the CN solves run under the memory planner's
plan (``plan_odeint`` in model mode, as the JAX example plans them): the
chosen checkpoint policy and ncheck are printed up front, and every CN
solver is built with them.  A budget below the smallest in-device
candidate (2000 bytes) plans pnode on the spill tier: the CN solvers then
run on the eager route (offload in the captured implicit form is ROADMAP
Queue 1 item 10a, and the example says so), with the same epoch-0 loss
and gradient, bitwise, as an in-device plan.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.adaptive import AdaptiveSolver
from repro_torch.core.implicit import ImplicitSolver
from repro_torch.models.ode_nets import mlp_vf, mlp_vf_init, resolve_device
from repro_torch.optim.adamw import AdamW

K1, K2, K3 = 0.04, 3e7, 1e4
#: the CN solver's Newton and GMRES caps (the JAX example's)
CN_KW = dict(method="cn", newton_iters=6, gmres_iters=10)


def robertson_rhs(u, _th, _t):
    u1, u2, u3 = u
    return torch.stack([
        -K1 * u1 + K3 * u2 * u3,
        K1 * u1 - K2 * u2 ** 2 - K3 * u2 * u3,
        K2 * u2 ** 2,
    ])


def robertson_truth(n_pts: int = 30, device="cpu", capture: bool = False):
    """Integrate the true Robertson system on a log-time grid (backward
    Euler with tiny steps — the reference trajectory).  Returns the times
    and the (n_pts, 3) fp64 states as numpy arrays.  ``capture`` runs each
    interval through a captured ``ImplicitSolver`` (bitwise the eager
    solve)."""
    ts = np.logspace(-5, 2, n_pts)
    u = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=device)
    traj = []
    t_prev = 0.0
    for t in ts:
        u, _ = ImplicitSolver(robertson_rhs, dt=(float(t) - t_prev) / 40,
                              n_steps=40, t0=t_prev, method="beuler",
                              newton_iters=20, capture=capture)(
                                  u, torch.zeros((), dtype=u.dtype,
                                                 device=u.device))
        traj.append(u.cpu().numpy())
        t_prev = float(t)
    return ts, np.array(traj)


def scaled_data(y: np.ndarray, device):
    """Min-max feature scaling (paper eq. 16) — crucial: u2 is ~1e-5
    scale.  Returns (y0, target) as fp64 tensors on ``device``."""
    lo, hi = y.min(axis=0), y.max(axis=0)
    y_s = torch.from_numpy((y - lo) / (hi - lo + 1e-12)).to(device)
    return y_s[0], y_s


def vector_field(u, theta, t):
    """``mlp_vf`` with the weights promoted to the state's dtype, as the JAX
    package's matmul of an fp64 state with fp32 weights promotes them (the
    gradient w.r.t. a weight comes back in its own dtype)."""
    return mlp_vf(u, pytree.tree_map(lambda p: p.to(u.dtype), theta), t)


class Losses(NamedTuple):
    """The two training losses and the solvers they run, one an interval."""
    cn: Callable
    dopri: Callable
    cn_solvers: list
    dopri_solvers: list


def make_losses(y0, target, *, adjoint: str = "pnode",
                ncheck: int | None = None, cn_stats: list | None = None,
                capture: bool = True, offload: str | None = None,
                snaps_in_ram: int | None = None) -> Losses:
    """The two training losses (MAE over the observation points, paper
    eq. 15): fixed-step CN over the scaled pseudo-time horizon, matching
    the observation points, and adaptive Dopri5 over the same intervals.
    ``adjoint``/``ncheck`` pick the CN checkpoint policy and ``offload``/
    ``snaps_in_ram`` its tier (an offloading CN solver runs on the eager
    route); each CN solve's ``ImplicitStats`` is appended to ``cn_stats``
    when given.  Each interval has its own solver (a solver's buffers hold
    its last call, and the losses chain 19 calls before the reverse
    sweep); ``capture`` replays CUDA graphs on the card."""
    n_obs = target.shape[0]
    cn_capture = capture and offload in (None, "device")
    cn_solvers = [ImplicitSolver(vector_field, dt=0.5, n_steps=2,
                                 t0=float(k), adjoint=adjoint, ncheck=ncheck,
                                 capture=cn_capture, offload=offload,
                                 snaps_in_ram=snaps_in_ram, **CN_KW)
                  for k in range(n_obs - 1)]
    dopri_solvers = [AdaptiveSolver(vector_field, t0=float(k),
                                    t1=float(k + 1), rtol=1e-6, atol=1e-6,
                                    max_steps=512, capture=capture)
                     for k in range(n_obs - 1)]

    def loss_cn(theta):
        us, u = [], y0
        for solver in cn_solvers:
            u, stats = solver(u, theta)
            if cn_stats is not None:
                cn_stats.append(stats)
            us.append(u)
        pred = torch.stack([y0] + us)
        return torch.mean(torch.abs(pred - target))

    def loss_dopri(theta):
        us, u = [], y0
        for solver in dopri_solvers:
            u, _ = solver(u, theta)
            us.append(u)
        pred = torch.stack([y0] + us)
        return torch.mean(torch.abs(pred - target))

    return Losses(loss_cn, loss_dopri, cn_solvers, dopri_solvers)


def value_and_grad(loss_fn, params):
    """(loss, gradient tree) of ``loss_fn`` at ``params``."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(pytree.tree_unflatten(leaves, spec))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def grad_norm(g) -> float:
    """sqrt(sum of squares) over the gradient's leaves, in their fp32."""
    return float(torch.sqrt(sum(torch.sum(x ** 2)
                                for x in pytree.tree_leaves(g))))


def train(loss_fn, theta, epochs: int, *, log=print):
    """AdamW on ``loss_fn`` from ``theta``, the JAX example's schedule.
    Returns losses, gradient norms, each epoch's host milliseconds (ending
    in a synchronize on the card) and the first epoch's gradient."""
    device = pytree.tree_leaves(theta)[0].device
    opt = AdamW(lr=5e-3, weight_decay=0.0, warmup_steps=10,
                total_steps=epochs)
    state, params = opt.init(theta), theta
    losses, gnorms, ms, grads0 = [], [], [], None
    for ep in range(epochs):
        t0 = time.perf_counter()
        loss, g = value_and_grad(loss_fn, params)
        with torch.no_grad():
            params, state, _ = opt.update(g, state, params)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        grads0 = g if grads0 is None else grads0
        losses.append(float(loss))
        gnorms.append(grad_norm(g))
        if ep % max(1, epochs // 10) == 0:
            log(f"  epoch {ep:4d} loss {losses[-1]:.5f} |g| "
                f"{gnorms[-1]:.3e}")
    return dict(losses=losses, gnorms=gnorms, ms=ms, grads0=grads0,
                params=params)


def plan_cn(y0, theta, mem_budget: int, *, log=print):
    """The memory planner's plan for one CN solve of the losses under
    ``mem_budget`` bytes (model mode, the JAX example's arguments), logged
    as the JAX example prints it."""
    from repro_torch.mem.planner import plan_odeint
    plan = plan_odeint(vector_field, y0, theta, dt=0.5, n_steps=2,
                       method="cn", mem_budget=mem_budget, verify="model",
                       solver_opts=dict(newton_iters=CN_KW["newton_iters"],
                                        gmres_iters=CN_KW["gmres_iters"]))
    log(f"planner @ {mem_budget} bytes: policy={plan.policy} "
        f"ncheck={plan.ncheck} offload={plan.offload} "
        f"predicted_peak={plan.predicted.peak_bytes}B "
        f"NFE-B={plan.extra_fevals} fits={plan.fits}")
    return plan


def run(epochs: int, *, hidden: int = 32, device="cuda", seed: int = 0,
        theta=None, capture: bool | None = None, adjoint: str = "pnode",
        ncheck: int | None = None, mem_budget: int | None = None,
        log=print):
    """The example: the truth, then CN and Dopri5 training of ``mlp_vf``
    (``hidden`` wide, 3 hidden layers; ``theta`` overrides the seeded
    weights).  ``capture`` as ``make_losses`` takes it, for the truth
    too; by default on the card only (on the CPU a captured solve runs
    the masked units eagerly, bitwise the eager route and slower).
    ``adjoint``/``ncheck`` pick the CN checkpoint policy; ``mem_budget``
    picks them (and the tier) through ``plan_cn`` instead.  Returns {"cn": ...,
    "dopri5": ...} as ``train`` returns, the CN solves' ``ImplicitStats``
    under "cn_stats", the ``Losses`` under "losses", the truth, and the
    plan (None without ``mem_budget``)."""
    device = resolve_device(device)
    if capture is None:
        capture = device.type == "cuda"
    ts, y = robertson_truth(20, device=device, capture=capture)
    y0, target = scaled_data(y, device)
    if theta is None:
        theta = mlp_vf_init(torch.Generator().manual_seed(seed), 3,
                            hidden=hidden, n_hidden=3, device=device)
    plan, offload, snaps_in_ram = None, None, None
    if mem_budget is not None:
        plan = plan_cn(y0, theta, mem_budget, log=log)
        adjoint, ncheck = plan.policy, plan.ncheck
        offload, snaps_in_ram = plan.offload, plan.snaps_in_ram
        if offload is not None:
            log(f"CN solvers run on the eager route: offload={offload!r} "
                "in the captured implicit form is ROADMAP Queue 1 item 10a")
    cn_stats: list = []
    losses = make_losses(y0, target, adjoint=adjoint, ncheck=ncheck,
                         cn_stats=cn_stats, capture=capture, offload=offload,
                         snaps_in_ram=snaps_in_ram)
    out = dict(ts=ts, truth=y, cn_stats=cn_stats, losses=losses, plan=plan)
    for key, name, loss_fn in (("cn", "CN (implicit)", losses.cn),
                               ("dopri5", "Dopri5 (explicit adaptive)",
                                losses.dopri)):
        log(f"\n=== training with {name} ===")
        t0 = time.perf_counter()
        out[key] = res = train(loss_fn, theta, epochs, log=log)
        log(f"  final loss {res['losses'][-1]:.5f}; max |g| "
            f"{max(res['gnorms']):.3e}; {time.perf_counter() - t0:.1f}s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mem-budget", type=int, default=None,
                    help="device-byte budget for the CN adjoint: the "
                         "memory planner picks the CN solvers' policy")
    args = ap.parse_args(argv)
    return run(args.epochs, hidden=args.hidden, device=args.device,
               seed=args.seed, mem_budget=args.mem_budget)


if __name__ == "__main__":
    main()
