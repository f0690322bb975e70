"""High-level discrete adjoint ODE solves with checkpointing (the paper's core).

``odeint(f, u0, theta, ...)`` integrates du/dt = f(u, theta, t) for a fixed
number of steps and differentiates with a selectable *adjoint policy*.  Every
baseline of the paper's Table 2 is implemented:

  naive       NODE-naive: autograd straight through the solver's steps
              (deepest graph: O(N_t N_s N_l) saved activations).
  continuous  NODE-cont (vanilla neural ODE): integrate the continuous
              adjoint ODE backward in time, re-solving the state backward.
              NOT reverse-accurate (O(h^2) per-step discrepancy, Prop. 1).
  anode       ANODE: checkpoint only the block input; in the reverse pass,
              recompute the whole forward and backprop through it.
  aca         ACA: checkpoint the state at every step; reverse pass
              re-executes each step under low-level AD (a vjp of the step).
  pnode       the paper's method: checkpoint states AND stage values at every
              step; reverse pass uses the high-level per-stage adjoint
              (rk_adjoint_step) — no recomputation, graph depth O(N_l).
  pnode2      PNODE2 variant: checkpoint solutions only; one step recompute
              per reverse step.
  revolve     PNODE with the binomial checkpointing schedule of Prop. 2
              (`ncheck` slots), trading recomputation for memory.
  revolve2    two-level binomial checkpointing: `ncheck` boundary states,
              each segment re-advanced once in the reverse pass.

Each custom-gradient policy is one ``torch.autograd.Function`` whose tensor
arguments are the flattened leaves of ``u0`` and ``theta``; the reverse
sweeps use ``torch.func.vjp``.  Gradients are returned w.r.t. ``u0`` and
``theta``.  ``t0``/``dt`` are Python floats.  Checkpoints live on the
device (the revolve store is a plain dict).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import revolve as revolve_mod
from repro_torch.core.integrators import (
    PyTree,
    VectorField,
    rk_adjoint_step,
    rk_combine,
    rk_stages,
    rk_step,
    solve_fixed,
    tree_add,
    tree_scale,
    tree_stack,
    tree_unstack,
    tree_zeros_like,
)
from repro_torch.core.tableaus import get_tableau

POLICIES = ("naive", "continuous", "anode", "aca", "pnode", "pnode2",
            "revolve", "revolve2")


def _t_of(t0: float, dt: float, n) -> float:
    return t0 + dt * n


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _validate_ncheck(adjoint: str, ncheck, n_steps: int) -> int:
    if ncheck is None:
        raise ValueError(
            f"adjoint={adjoint!r} requires ncheck (the number of checkpoint "
            "slots); pass it explicitly")
    ncheck = int(ncheck)
    if ncheck <= 0:
        raise ValueError(
            f"ncheck must be a positive number of checkpoint slots, got "
            f"{ncheck} (the reverse sweep needs at least one free slot to "
            "re-advance a segment)")
    if ncheck >= n_steps:
        raise ValueError(
            f"ncheck={ncheck} must be < n_steps={n_steps}: with a slot for "
            "every step there is nothing to recompute — that point of the "
            "memory/compute curve is adjoint='pnode'")
    return ncheck


#: policies whose reverse pass never differentiates *through* a step graph
#: (states/stages are checkpointed, the adjoint is the explicit per-stage
#: recursion) — the only ones the fused stage kernel applies to: the kernel
#: has no autograd rule, so policies that take a vjp through the step
#: (naive/continuous/anode/aca) keep the unfused chain.
_FUSED_POLICIES = ("pnode", "pnode2", "revolve", "revolve2")


def odeint(f: VectorField, u0: PyTree, theta: PyTree, *, dt: float,
           n_steps: int, t0: float = 0.0, method: str = "rk4",
           adjoint: str = "pnode", ncheck: int | None = None,
           fused_stages: bool = False) -> PyTree:
    """Fixed-step ODE solve, differentiable with the selected adjoint policy.

    ``fused_stages=True`` makes the RK stage-update chain (forward) and the
    per-stage adjoint recursion (reverse) single launches of the Hopper
    linear-combination kernel (``kernels.ops.fused_lincomb``; its plain
    version on CPU tensors).  Gradients are bitwise-identical to the
    unfused path on the same device.  Only the checkpointing policies
    (pnode/pnode2/revolve/revolve2) support it — the low-level-AD policies
    differentiate through the step graph and the kernel has no autograd
    rule.
    """
    n_steps = int(n_steps)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if adjoint not in POLICIES:
        raise ValueError(f"unknown adjoint policy {adjoint!r}; one of "
                         f"{POLICIES}")
    if fused_stages and adjoint not in _FUSED_POLICIES:
        raise ValueError(
            f"fused_stages=True is not supported for "
            f"adjoint={adjoint!r}: that policy differentiates through "
            "the step graph and the fused stage kernel has no autograd "
            f"rule; use one of {_FUSED_POLICIES}")
    fused = bool(fused_stages)
    t0, dt = float(t0), float(dt)
    if adjoint == "naive":
        u_final, _ = solve_fixed(f, method, u0, theta, t0, dt, n_steps)
        return u_final
    if adjoint in ("revolve", "revolve2"):
        ncheck = _validate_ncheck(adjoint, ncheck, n_steps)
    solver = _Solver(f, method, t0, dt, n_steps, adjoint, fused, ncheck)
    return solver(u0, theta)


def nfe_forward(method: str, n_steps: int) -> int:
    return get_tableau(method).num_stages * n_steps


def adjoint_stages(method: str) -> int:
    """Stages the discrete adjoint actually linearizes: stage i is skipped
    when b_i == 0 and no later stage depends on it (e.g. dopri5's 7th/FSAL
    stage), so NFE-B can be below N_s per step."""
    tab = get_tableau(method)
    s = tab.num_stages
    return sum(
        1 for i in range(s)
        if float(tab.b[i]) != 0.0
        or any(float(tab.a[j, i]) != 0.0 for j in range(i + 1, s)))


def nfe_backward(method: str, n_steps: int, adjoint: str,
                 ncheck: int | None = None) -> int:
    """Analytic NFE-B (f evaluations in the reverse pass), Table-2 accounting.

    A transposed JVP of f costs one f evaluation (linearization); a recomputed
    step costs N_s evaluations.
    """
    s = get_tableau(method).num_stages
    sa = adjoint_stages(method)
    if adjoint == "naive":
        return 0
    if adjoint == "continuous":
        # backward solve of the augmented system: one f linearization per stage
        return s * n_steps
    if adjoint == "anode":
        # full forward recompute + backprop through it
        return 2 * s * n_steps
    if adjoint == "aca":
        # re-execute each step (s evals) + backprop its graph (s evals)
        return 2 * s * n_steps
    if adjoint == "pnode":
        return sa * n_steps
    if adjoint == "pnode2":
        # recompute stages of each step + per-stage vjps
        return s * n_steps + sa * n_steps
    if adjoint == "revolve":
        extra = revolve_mod.optimal_extra_steps(n_steps, ncheck)
        return s * extra + sa * n_steps
    if adjoint == "revolve2":
        # each non-boundary step re-advanced exactly once
        n_bound = len(revolve_mod.sweep_checkpoint_positions(n_steps,
                                                             ncheck)) + 1
        return s * (n_steps - n_bound) + sa * n_steps
    raise ValueError(adjoint)


def checkpoint_floats(method: str, n_steps: int, adjoint: str, state_size: int,
                      ncheck: int | None = None) -> int:
    """Analytic checkpoint storage (in state-vector units x state_size)."""
    s = get_tableau(method).num_stages
    if adjoint in ("naive",):
        return 0
    if adjoint == "continuous":
        return 0
    if adjoint == "anode":
        return state_size
    if adjoint == "aca":
        return n_steps * state_size
    if adjoint == "pnode":
        return n_steps * (s + 1) * state_size
    if adjoint == "pnode2":
        return n_steps * state_size
    if adjoint == "revolve":
        return (ncheck + 1) * (s + 1) * state_size  # +1: segment boundary
    if adjoint == "revolve2":
        # boundary states + one in-flight segment of states+stages
        bounds = [0] + revolve_mod.sweep_checkpoint_positions(n_steps, ncheck)
        seg = max(b - a for a, b in zip(bounds, bounds[1:] + [n_steps]))
        return (len(bounds) + seg * (s + 1)) * state_size
    raise ValueError(adjoint)


def expected_lincomb_calls(method: str, n_steps: int, n_leaves: int,
                           policy: str, ncheck: int | None = None,
                           backward: bool = True) -> int:
    """Fused lincomb launches (or plain calls on the CPU) that one fused
    ``odeint`` makes: its forward solve, plus its reverse sweep when
    ``backward``.  Mirrors the skip rules of ``tree_stage_lincomb`` and
    ``rk_adjoint_step``: zero weights are dropped, an empty pair list
    launches nothing, and a stage the adjoint skips (dopri5's 7th)
    contributes no term.  One launch per leaf; no leaf may be empty.
    E.g. rk4, N_t = 4, one leaf: 16 forward + 24 reverse = 40."""
    if policy not in _FUSED_POLICIES:
        raise ValueError(f"adjoint={policy!r} cannot run fused; one of "
                         f"{_FUSED_POLICIES}")
    tab = get_tableau(method)
    s = tab.num_stages
    a, b = tab.a, tab.b
    stage_in = sum(1 for i in range(s) if any(a[i, j] != 0 for j in range(i)))
    step = stage_in + int(any(b != 0))            # rk_stages + rk_combine
    active = [b[i] != 0 or any(a[j, i] != 0 for j in range(i + 1, s))
              for i in range(s)]
    v_launch = sum(1 for i in range(s) if active[i] and any(
        a[j, i] != 0 and active[j] for j in range(i + 1, s)))
    adj = stage_in + v_launch                     # rk_adjoint_step
    fwd = n_steps * step
    if not backward:
        return fwd * n_leaves
    if policy == "pnode":
        bwd = n_steps * adj
    elif policy == "pnode2":
        bwd = n_steps * (stage_in + adj)
    elif policy == "revolve2":
        bwd = n_steps * (step + adj)
    else:  # revolve: replay the schedule
        ncheck = _validate_ncheck(policy, ncheck, n_steps)
        bwd = 0
        for act in revolve_mod.reverse_schedule(n_steps, ncheck):
            if act[0] == "advance":
                bwd += 1 + (act[2] - 1) * step + step
            elif act[0] == "adjoint":
                bwd += adj
    return (fwd + bwd) * n_leaves


# ---------------------------------------------------------------------------
# custom-gradient policies: one autograd.Function over the flattened leaves
# ---------------------------------------------------------------------------

class _Solver:
    """Binds one policy's forward/reverse sweeps to the autograd Function."""

    def __init__(self, f, method, t0, dt, n_steps, policy, fused, ncheck):
        self.f, self.method, self.t0, self.dt = f, method, t0, dt
        self.n_steps, self.policy, self.fused = n_steps, policy, fused
        self.ncheck = ncheck
        self.tab = get_tableau(method)

    def __call__(self, u0, theta):
        u_leaves, self.u_spec = pytree.tree_flatten(u0)
        th_leaves, self.th_spec = pytree.tree_flatten(theta)
        if not (torch.is_grad_enabled() and any(
                x.requires_grad for x in u_leaves + th_leaves)):
            # nothing to differentiate: the plain solve, no checkpoints
            u_final, _ = solve_fixed(self.f, self.method, u0, theta, self.t0,
                                     self.dt, self.n_steps, fused=self.fused)
            return u_final
        self.n_u = len(u_leaves)
        out = _PolicyFunction.apply(self, *u_leaves, *th_leaves)
        return pytree.tree_unflatten(list(out), self.out_spec)

    def unflatten(self, leaves):
        return (pytree.tree_unflatten(list(leaves[:self.n_u]), self.u_spec),
                pytree.tree_unflatten(list(leaves[self.n_u:]), self.th_spec))

    # -- forward sweeps: (u_final, residuals) -------------------------------
    def forward(self, u0, theta):
        f, m, t0, dt, n, fused = (self.f, self.method, self.t0, self.dt,
                                  self.n_steps, self.fused)
        p = self.policy
        if p in ("continuous", "anode"):
            u_final, _ = solve_fixed(f, m, u0, theta, t0, dt, n)
            return u_final, (u_final if p == "continuous" else u0)
        if p in ("aca", "pnode2"):
            u_final, saved = solve_fixed(f, m, u0, theta, t0, dt, n,
                                         save_states=True, fused=fused)
            return u_final, saved["states"]
        if p == "pnode":
            u_final, saved = solve_fixed(f, m, u0, theta, t0, dt, n,
                                         save_states=True, save_stages=True,
                                         fused=fused)
            return u_final, (saved["states"], saved["stages"])
        if p == "revolve":
            return self._revolve_fwd(u0, theta)
        if p == "revolve2":
            return self._revolve2_fwd(u0, theta)
        raise ValueError(p)

    # -- reverse sweeps: (lam, mu) ------------------------------------------
    def backward(self, res, theta, g):
        f, m, tab, t0, dt, n, fused = (self.f, self.method, self.tab, self.t0,
                                       self.dt, self.n_steps, self.fused)
        p = self.policy
        if p == "continuous":
            u_final = res

            def aug_f(state, th, t):
                u, lam, _ = state
                fval, vjp_fn = torch.func.vjp(lambda uu, tt: f(uu, tt, t),
                                              u, th)
                u_bar, th_bar = vjp_fn(lam)
                # integrated backward in time with negative dt below, so
                # signs follow d(lam)/dt = -f_u^T lam, d(mu)/dt = -f_th^T lam
                return (fval, tree_scale(-1.0, u_bar),
                        tree_scale(-1.0, th_bar))

            state0 = (u_final, g, tree_zeros_like(theta))
            tF = t0 + dt * n
            state_final, _ = solve_fixed(aug_f, m, state0, theta, tF, -dt, n)
            _, lam, mu = state_final
            return lam, mu

        if p == "anode":
            def full(u0_, th_):
                uf, _ = solve_fixed(f, m, u0_, th_, t0, dt, n)
                return uf

            _, vjp_fn = torch.func.vjp(full, res, theta)
            return vjp_fn(g)

        lam, mu = g, tree_zeros_like(theta)
        if p == "aca":
            def step_fn(u, th, t):
                u_next, _ = rk_step(f, tab, u, th, t, dt)
                return u_next

            for k in reversed(range(n)):
                t_k = _t_of(t0, dt, k)
                _, vjp_fn = torch.func.vjp(
                    lambda uu, th: step_fn(uu, th, t_k), res[k], theta)
                lam, th_bar = vjp_fn(lam)
                mu = tree_add(mu, th_bar)
            return lam, mu

        if p == "pnode":
            states, stages = res
            for k in reversed(range(n)):
                lam, th_bar = rk_adjoint_step(f, tab, states[k], stages[k],
                                              theta, _t_of(t0, dt, k), dt,
                                              lam, fused=fused)
                mu = tree_add(mu, th_bar)
                states[k] = stages[k] = None  # free as the sweep passes
            return lam, mu

        if p == "pnode2":
            for k in reversed(range(n)):
                t_k = _t_of(t0, dt, k)
                ks = rk_stages(f, tab, res[k], theta, t_k, dt,  # recompute
                               fused=fused)
                lam, th_bar = rk_adjoint_step(f, tab, res[k], tree_stack(ks),
                                              theta, t_k, dt, lam, fused=fused)
                mu = tree_add(mu, th_bar)
                res[k] = None
            return lam, mu

        if p == "revolve":
            return self._revolve_bwd(res, theta, lam, mu)
        if p == "revolve2":
            return self._revolve2_bwd(res, theta, lam, mu)
        raise ValueError(p)

    # -- revolve: binomial checkpointing, schedule replayed eagerly ---------
    def _advance(self, u, theta, start, count):
        """Run ``count`` plain RK steps from u starting at step ``start``."""
        for k in range(count):
            u, _ = rk_step(self.f, self.tab, u, theta,
                           _t_of(self.t0, self.dt, start + k), self.dt,
                           fused=self.fused)
        return u

    def _revolve_fwd(self, u0, theta):
        positions = [0] + revolve_mod.sweep_checkpoint_positions(
            self.n_steps, self.ncheck)
        store: dict = {}
        u = u0
        bounds = positions + [self.n_steps]
        for a, b in zip(bounds[:-1], bounds[1:]):
            # step a runs explicitly to capture its stages for the checkpoint
            u_next, stages_a = rk_step(self.f, self.tab, u, theta,
                                       _t_of(self.t0, self.dt, a), self.dt,
                                       fused=self.fused)
            store[a] = (u, stages_a)
            u = self._advance(u_next, theta, a + 1, b - a - 1)
        return u, store

    def _revolve_bwd(self, store, theta, lam, mu):
        tab, dt = self.tab, self.dt
        for act in revolve_mod.reverse_schedule(self.n_steps, self.ncheck):
            kind = act[0]
            if kind == "advance":
                _, start, m = act
                u_s, st_s = store[start]
                # stage-combine restart: u_{start+1} with zero f evaluations
                u = rk_combine(tab, u_s, tree_unstack(st_s, tab.num_stages),
                               dt, fused=self.fused)
                u = self._advance(u, theta, start + 1, m - 1)
                _, stages_tgt = rk_step(self.f, tab, u, theta,
                                        _t_of(self.t0, dt, start + m), dt,
                                        fused=self.fused)
                store[start + m] = (u, stages_tgt)
            elif kind == "adjoint":
                _, idx = act
                u_i, st_i = store.pop(idx)
                lam, th_bar = rk_adjoint_step(self.f, tab, u_i, st_i, theta,
                                              _t_of(self.t0, dt, idx), dt,
                                              lam, fused=self.fused)
                mu = tree_add(mu, th_bar)
            elif kind == "free":
                store.pop(act[1], None)
            else:  # pragma: no cover
                raise ValueError(act)
        return lam, mu

    # -- revolve2: boundary states, each segment re-advanced once ----------
    def _segment_bounds(self):
        positions = [0] + revolve_mod.sweep_checkpoint_positions(
            self.n_steps, self.ncheck)
        return list(zip(positions, positions[1:] + [self.n_steps]))

    def _revolve2_fwd(self, u0, theta):
        store: dict = {}
        u = u0
        for a, b in self._segment_bounds():
            store[a] = u
            u = self._advance(u, theta, a, b - a)
        return u, store

    def _revolve2_bwd(self, store, theta, lam, mu):
        t0, dt = self.t0, self.dt
        for a, b in reversed(self._segment_bounds()):
            m = b - a
            u_a = store.pop(a)
            # re-advance the segment, saving states and stages
            _, saved = solve_fixed(self.f, self.method, u_a, theta,
                                   t0 + dt * a, dt, m, save_states=True,
                                   save_stages=True, fused=self.fused)
            for k in reversed(range(m)):
                lam, th_bar = rk_adjoint_step(
                    self.f, self.tab, saved["states"][k], saved["stages"][k],
                    theta, t0 + dt * (a + k), dt, lam, fused=self.fused)
                mu = tree_add(mu, th_bar)
        return lam, mu


class _PolicyFunction(torch.autograd.Function):
    """Custom gradient of one checkpointing policy.  Inputs are the
    flattened leaves of u0 then theta; outputs the leaves of u_final."""

    @staticmethod
    def forward(ctx, solver: _Solver, *leaves):
        # detached: the checkpoints and the reverse sweep's recomputes must
        # record no graph of their own
        u0, theta = solver.unflatten([x.detach() for x in leaves])
        u_final, res = solver.forward(u0, theta)
        out, solver.out_spec = pytree.tree_flatten(u_final)
        ctx.solver, ctx.res, ctx.theta = solver, res, theta
        return tuple(out)

    @staticmethod
    def backward(ctx, *g_leaves):
        solver, res, theta = ctx.solver, ctx.res, ctx.theta
        ctx.res = ctx.theta = None  # one reverse sweep consumes the residuals
        if res is None:
            raise RuntimeError("odeint's reverse sweep ran twice; its "
                               "checkpoints are consumed by the first")
        g = pytree.tree_unflatten(list(g_leaves), solver.out_spec)
        # torch.func.vjp differentiates inside the sweep even though autograd
        # records nothing here (backward runs under no_grad)
        lam, mu = solver.backward(res, theta, g)
        return (None, *(x.detach() for x in pytree.tree_leaves((lam, mu))))


# ---------------------------------------------------------------------------
# trajectory-loss support (the paper's eq. 2 integral term)
# ---------------------------------------------------------------------------

def odeint_with_quadrature(f: VectorField, q, u0: PyTree, theta: PyTree, *,
                           dt: float, n_steps: int, t0: float = 0.0,
                           method: str = "rk4", adjoint: str = "pnode",
                           ncheck: int | None = None,
                           fused_stages: bool = False):
    """Integrate du/dt = f AND the loss quadrature dQ/dt = q(u, theta, t)
    jointly (eq. 2's integral term: running costs / Tikhonov / kinetic
    regularizers a la Finlay et al.).  Returns (u_final, Q).

    The augmented system is just another vector field, so every adjoint
    policy — including revolve checkpointing — applies unchanged, and the
    gradient of any function of (u_final, Q) is reverse-accurate.  Q starts
    as a 0-dim zero of u0's (first leaf's) dtype and device."""
    def aug(state, th, t):
        u, _ = state
        return (f(u, th, t), q(u, th, t))

    ref = pytree.tree_leaves(u0)[0]
    q0 = torch.zeros((), dtype=ref.dtype, device=ref.device)
    u_final, Q = odeint(aug, (u0, q0), theta, dt=dt, n_steps=n_steps, t0=t0,
                        method=method, adjoint=adjoint, ncheck=ncheck,
                        fused_stages=fused_stages)
    return u_final, Q
