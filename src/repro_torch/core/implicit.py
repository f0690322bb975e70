"""Implicit time integration with discrete adjoints (paper §3.3).

Theta-method family:  u_{n+1} = u_n + h [ (1-theta) f(u_n) + theta f(u_{n+1}) ]
  theta = 1.0  -> backward Euler   (paper eq. 12)
  theta = 0.5  -> Crank-Nicolson   (used for the stiff Robertson system, §5.3)

Forward pass: Newton iterations; each Newton step solves the linear system
(I - h*theta*J) dv = -r with matrix-free GMRES (``core/gmres.py``, the
algorithm of ``jax.scipy.sparse.linalg.gmres(solve_method="incremental")``
that the JAX package calls), the action of J = df/du supplied by
``torch.func.jvp`` — the paper's "matrix-free iterative method whose matrix
action comes from AD" design.

Reverse pass (discrete adjoint, paper eq. 13 generalized to theta-methods):
    (I - h*theta*f_u(u_{n+1}))^T lam_s = lam_{n+1}          (transposed GMRES,
                                                     action by torch.func.vjp)
    lam_n  = (I + h*(1-theta)*f_u(u_n))^T lam_s
    mu_n  += h * [ (1-theta) f_th(u_n) + theta f_th(u_{n+1}) ]^T lam_s

The nonlinear and linear solvers never enter the backpropagation graph —
only ``f`` is differentiated — so a checkpoint is one converged state
vector; the Newton/GMRES iterates are never stored.

Checkpoint policies (``adjoint=``), on the device (a Python list or dict of
the state's tensors):

  pnode     store every converged state u_0..u_{N-1} (+ u_final); the
            reverse pass solves one transposed linear system per step with
            zero recomputation.
  revolve   binomial (Prop. 2) checkpoint schedule over states only:
            ``ncheck`` slots, segments re-advanced by re-running the Newton
            solve; a slot costs S floats, not (N_s+1)S.
  revolve2  two-level variant: boundary states, each segment re-advanced
            once and adjointed.

Recomputed states are bitwise the forward sweep's (the same operations in
the same order), so the three policies give bitwise equal gradients on one
device.  ``adjoint="naive"`` is impossible by construction: Newton/GMRES
have no reverse rule — the paper's motivating limitation.

The Newton and GMRES exits are read on the host, one device-to-host read
per iteration, so a solve runs eagerly (it is not captured as a CUDA
graph).  ``odeint_implicit(..., return_stats=True)`` returns
``(u_final, ImplicitStats)``: ``diverged`` is True if any step exhausted
``newton_iters`` with residual > ``newton_tol``.

Not ported (they raise ``NotImplementedError``): the host/spill/disk
checkpoint tiers and their knobs (``offload``, ``offload_segment``,
``snaps_in_ram``, ``offload_dir``, ``resilient``; ROADMAP Queue 1
item 10), the memory planner (``adjoint="auto"``, ``mem_budget``; item 9)
and the flight recorder and fault injection (``obs``, ``fault_plan``;
item 11).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import revolve as revolve_mod
from repro_torch.core.adjoint import _validate_ncheck
from repro_torch.core.gmres import gmres
from repro_torch.core.integrators import (
    PyTree,
    VectorField,
    tree_add,
    tree_axpy,
    tree_map,
    tree_norm,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

IMPLICIT_METHODS = ("beuler", "cn")
IMPLICIT_POLICIES = ("pnode", "revolve", "revolve2")
_OFFLOAD_TIERS = (None, "device", "host", "spill", "disk")


def _mass_apply(mass):
    if mass is None:
        return lambda u: u
    if callable(mass):
        return mass
    return lambda u: tree_map(lambda x: mass @ x, u)


def _mass_apply_t(mass):
    if mass is None:
        return lambda u: u
    if callable(mass):  # caller supplies a self-adjoint / explicit transpose
        return mass
    return lambda u: tree_map(lambda x: mass.T @ x, u)


def _theta_of(method: str) -> float:
    if method == "beuler":
        return 1.0
    if method == "cn":
        return 0.5
    raise ValueError(f"unknown implicit method {method!r}; use 'beuler' or "
                     "'cn'")


def is_implicit_method(method: str) -> bool:
    return method in IMPLICIT_METHODS


def _nanmax(a: float, b: float) -> float:
    """max that propagates NaN, as ``jnp.maximum`` does."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


class StepInfo(NamedTuple):
    """Per-step Newton exit state (host values: the exit is read there)."""
    iters: int         # Newton iterations taken
    residual: float    # final ||residual|| at exit
    converged: bool    # residual <= newton_tol at exit


class ImplicitStats(NamedTuple):
    """Solve-level convergence report (see ``return_stats=``)."""
    diverged: bool         # any step exited on newton_iters with r > tol
    max_residual: float    # worst final Newton residual across steps
    newton_iters: int      # total Newton iterations over the solve
    rescued: int           # steps recovered by a rescue retry


class RescueConfig(NamedTuple):
    """Divergence-rescue knobs (``odeint_implicit(rescue=...)``).

    On a failed step (Newton exhausted its iteration cap, or a non-finite
    state), the step is retried with an ESCALATED iteration cap: retry r
    gets ``newton_iters * escalate**r`` iterations.  The Newton loop exits
    on ``residual <= tol``, so a retry that converges where the first
    attempt would have converged gives bit-identical values — the
    escalated cap only matters when it binds.  ``dt_halving`` adds a last
    resort after all retries: two h/2 sub-steps (the method's order is
    kept; values are NOT bitwise the single step's)."""
    max_retries: int = 1
    escalate: int = 4
    dt_halving: bool = True


class _SolverConfig(NamedTuple):
    theta: float
    newton_iters: int
    newton_tol: float
    gmres_iters: int
    gmres_tol: float
    rescue: RescueConfig | None = None


def _stats_zero() -> ImplicitStats:
    return ImplicitStats(False, 0.0, 0, 0)


def _stats_merge(stats: ImplicitStats, info: StepInfo,
                 rescued: int = 0) -> ImplicitStats:
    return ImplicitStats(stats.diverged or not info.converged,
                         _nanmax(stats.max_residual, info.residual),
                         stats.newton_iters + info.iters,
                         stats.rescued + rescued)


# ---------------------------------------------------------------------------
# one implicit step (forward) and its discrete adjoint
# ---------------------------------------------------------------------------

def implicit_step(f: VectorField, u_n: PyTree, theta_p: PyTree, t_n, h,
                  theta: float, newton_iters: int = 10,
                  newton_tol: float = 1e-9, gmres_iters: int = 20,
                  gmres_tol: float = 1e-10, mass=None):
    """Solve M u_{n+1} = M u_n + h[(1-theta) f(u_n, t_n) + theta f(u_{n+1},
    t_{n+1})] (eq. 12 generalized; mass=None means M = I) by Newton from an
    explicit-Euler predictor.

    Returns ``(u_{n+1}, StepInfo)``; the converged flag is the Newton exit
    condition ``residual <= newton_tol``.
    """
    t_next = t_n + h
    f_n = f(u_n, theta_p, t_n)
    apply_m = _mass_apply(mass)
    # constant part g = M u_n + h (1-theta) f_n
    g_const = tree_axpy(h * (1.0 - theta), f_n, apply_m(u_n))

    def residual(v):
        return tree_sub(tree_axpy(-h * theta, f(v, theta_p, t_next),
                                  apply_m(v)), g_const)

    # predictor: explicit Euler
    v = tree_axpy(h, f_n, u_n)
    it = 0
    rnorm = float(tree_norm(residual(v)))
    while it < newton_iters and rnorm > newton_tol:
        r = residual(v)

        def jv(w, v=v):
            # (M - h*theta*J) w, J = df/du at v — matrix-free via jvp
            _, jw = torch.func.jvp(lambda uu: f(uu, theta_p, t_next),
                                   (v,), (w,))
            return tree_axpy(-h * theta, jw, apply_m(w))

        dv, _ = gmres(jv, tree_scale(-1.0, r), tol=gmres_tol,
                      maxiter=gmres_iters)
        v = tree_add(v, dv)
        it += 1
        rnorm = float(tree_norm(residual(v)))
    return v, StepInfo(it, rnorm, rnorm <= newton_tol)


def implicit_adjoint_step(f: VectorField, u_n: PyTree, u_next: PyTree,
                          theta_p: PyTree, t_n, h, theta: float,
                          lam: PyTree, gmres_iters: int = 20,
                          gmres_tol: float = 1e-10, mass=None):
    """One reverse step of the theta-method discrete adjoint (eq. 13)."""
    t_next = t_n + h
    apply_mt = _mass_apply_t(mass)

    # transposed linear solve: (M - h*theta*f_u(u_next))^T lam_s = lam
    _, vjp_next = torch.func.vjp(lambda uu, th: f(uu, th, t_next), u_next,
                                 theta_p)

    def jtv(w):
        u_bar, _ = vjp_next(w)
        return tree_axpy(-h * theta, u_bar, apply_mt(w))

    lam_s, _ = gmres(jtv, lam, tol=gmres_tol, maxiter=gmres_iters)

    # lam_n = M^T lam_s + h(1-theta) f_u(u_n)^T lam_s
    _, vjp_n = torch.func.vjp(lambda uu, th: f(uu, th, t_n), u_n, theta_p)
    u_bar_n, th_bar_n = vjp_n(tree_scale(h * (1.0 - theta), lam_s))
    lam_prev = tree_add(apply_mt(lam_s), u_bar_n)

    # mu increment
    _, th_bar_next = vjp_next(tree_scale(h * theta, lam_s))
    th_bar = tree_add(th_bar_n, th_bar_next)
    return lam_prev, th_bar


def _tree_allfinite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in pytree.tree_leaves(tree))


def _rescued_step(f, cfg: _SolverConfig, u, theta_p, t_n, h):
    """One implicit step under divergence rescue.  Attempt 0 runs at the
    configured iteration cap; a failed attempt (not converged, or a
    non-finite state) falls through ``max_retries`` retries at escalated
    Newton caps — bit-identical to attempt 0 whenever that would have
    converged, because the Newton loop exits on residual <= tol — then
    optionally two h/2 sub-steps as a non-bitwise last resort.  Returns
    ``(u_next, StepInfo, rescued)``, ``rescued`` 1 when the accepted result
    came from a retry or the halving."""
    rescue = cfg.rescue

    def attempt(iters, uu, tt, hh):
        return implicit_step(f, uu, theta_p, tt, hh, cfg.theta, int(iters),
                             cfg.newton_tol, cfg.gmres_iters, cfg.gmres_tol)

    def halved():
        cap = cfg.newton_iters * (rescue.escalate ** max(rescue.max_retries,
                                                         1))
        u_half, ia = attempt(cap, u, t_n, h * 0.5)
        u_full, ib = attempt(cap, u_half, t_n + h * 0.5, h * 0.5)
        info = StepInfo(ia.iters + ib.iters,
                        _nanmax(ia.residual, ib.residual),
                        ia.converged and ib.converged)
        return u_full, info

    makers = [lambda: attempt(cfg.newton_iters, u, t_n, h)]
    for r in range(1, rescue.max_retries + 1):
        cap = cfg.newton_iters * (rescue.escalate ** r)
        makers.append(lambda cap=cap: attempt(cap, u, t_n, h))
    if rescue.dt_halving:
        makers.append(halved)
    for i, make in enumerate(makers):
        u1, info = make()
        ok = info.converged and _tree_allfinite(u1)
        if ok or i == len(makers) - 1:
            return u1, info, int(ok and i > 0)


def _step(f, cfg: _SolverConfig, u, theta_p, t_n, h):
    """Returns ``(u_next, StepInfo, rescued)``."""
    if cfg.rescue is None:
        u_next, info = implicit_step(f, u, theta_p, t_n, h, cfg.theta,
                                     cfg.newton_iters, cfg.newton_tol,
                                     cfg.gmres_iters, cfg.gmres_tol)
        return u_next, info, 0
    return _rescued_step(f, cfg, u, theta_p, t_n, h)


def _adjoint_step(f, cfg: _SolverConfig, u_n, u_next, theta_p, t_n, h, lam):
    return implicit_adjoint_step(f, u_n, u_next, theta_p, t_n, h, cfg.theta,
                                 lam, cfg.gmres_iters, cfg.gmres_tol)


# ---------------------------------------------------------------------------
# Table-2-style accounting for the implicit family (the planner's model)
# ---------------------------------------------------------------------------

def implicit_step_fevals(newton_iters: int = 10,
                         gmres_iters: int = 20) -> int:
    """f evaluations one implicit step costs (the recompute unit): the
    predictor's f, plus per Newton iteration one residual f, one f
    linearization per GMRES iteration (the jvp matrix action), and the
    exit-residual f."""
    return int(newton_iters) * (int(gmres_iters) + 2) + 1


def implicit_adjoint_fevals(gmres_iters: int = 20) -> int:
    """f linearizations one discrete-adjoint step costs (NFE-B unit): one
    vjp application per transposed-GMRES iteration plus the two explicit
    vjps (lam_n and the theta increment)."""
    return int(gmres_iters) + 2


def implicit_nfe_forward(n_steps: int, newton_iters: int = 10,
                         gmres_iters: int = 20) -> int:
    return n_steps * implicit_step_fevals(newton_iters, gmres_iters)


def implicit_nfe_backward(n_steps: int, adjoint: str,
                          ncheck: int | None = None,
                          newton_iters: int = 10,
                          gmres_iters: int = 20) -> int:
    """Analytic NFE-B for the implicit policies: every policy pays one
    transposed-GMRES adjoint solve per step; revolve/revolve2 additionally
    re-run the Newton solve for recomputed steps."""
    adj = n_steps * implicit_adjoint_fevals(gmres_iters)
    stepc = implicit_step_fevals(newton_iters, gmres_iters)
    if adjoint == "pnode":
        return adj
    if adjoint == "revolve":
        return revolve_mod.optimal_extra_steps(n_steps, ncheck) * stepc + adj
    if adjoint == "revolve2":
        n_bound = len(revolve_mod.sweep_checkpoint_positions(
            n_steps, ncheck)) + 1
        return (n_steps - n_bound) * stepc + adj
    raise ValueError(adjoint)


def implicit_checkpoint_floats(n_steps: int, adjoint: str, state_size: int,
                               ncheck: int | None = None) -> int:
    """Checkpoint storage in floats: ONLY converged states are stored (the
    Newton/GMRES iterates never enter the graph), so a slot costs S — not
    the explicit family's (N_s+1)S."""
    if adjoint == "pnode":
        return (n_steps + 1) * state_size
    if adjoint == "revolve":
        return (ncheck + 1) * state_size
    if adjoint == "revolve2":
        bounds = [0] + revolve_mod.sweep_checkpoint_positions(n_steps, ncheck)
        seg = max(b - a for a, b in zip(bounds, bounds[1:] + [n_steps]))
        return (len(bounds) + seg + 1) * state_size
    raise ValueError(adjoint)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _not_ported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"odeint_implicit: {what} is not ported yet: ROADMAP Queue 1 item "
        f"{item} ({name}); checkpoints live on the device")


def odeint_implicit(f: VectorField, u0: PyTree, theta_p: PyTree, *, dt: float,
                    n_steps: int, t0: float = 0.0, method: str = "cn",
                    adjoint: str = "pnode", ncheck: int | None = None,
                    offload: str | None = None,
                    offload_segment: int | None = None,
                    snaps_in_ram: int | None = None,
                    offload_dir: str | None = None,
                    mem_budget: int | None = None,
                    mem_verify: str = "measure",
                    newton_iters: int = 10, newton_tol: float = 1e-9,
                    gmres_iters: int = 20, gmres_tol: float = 1e-10,
                    mass=None, return_stats: bool = False,
                    obs=None, rescue=None, fault_plan=None,
                    resilient: bool = False) -> PyTree:
    """Fixed-step implicit theta-method solve with a discrete adjoint.
    ``adjoint`` selects the checkpoint policy (``pnode`` dense states /
    ``revolve`` / ``revolve2``, with ``ncheck`` slots for the last two).
    Differentiable w.r.t. the tensor leaves of ``u0`` and ``theta_p``.
    ``return_stats=True`` returns ``(u_final, ImplicitStats)`` so Newton
    non-convergence surfaces as ``stats.diverged`` instead of silently
    wrong states and gradients.  ``rescue=`` a ``RescueConfig`` (or
    ``True`` for the defaults) retries a failed step at escalated Newton
    caps, then optionally as two half steps; ``stats.rescued`` counts the
    rescued steps.  ``mass=`` (a matrix or a callable) solves
    M u' = f, forward only.  ``t0``/``dt`` are Python floats; step n starts
    at ``t0 + dt * n``.  The module docstring lists the options that are
    not ported."""
    n_steps = int(n_steps)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    theta = _theta_of(method)
    if obs is not None or fault_plan is not None:
        raise _not_ported("obs= / fault_plan=", 11,
                          "the flight recorder and fault injection")
    if mass is not None:
        if (adjoint != "pnode" or offload is not None
                or mem_budget is not None or rescue is not None
                or resilient):
            raise ValueError(
                "mass-matrix solves support only the default dense path "
                "(adjoint='pnode', no offload/mem_budget and no "
                "rescue/resilient): the mass operator is closed over "
                "statically and the solve is forward-only")
        return _odeint_implicit_mass(f, mass, float(t0), float(dt), n_steps,
                                     theta, int(newton_iters),
                                     float(newton_tol), int(gmres_iters),
                                     float(gmres_tol), u0, theta_p,
                                     return_stats)
    if adjoint == "auto" or mem_budget is not None:
        raise _not_ported("adjoint='auto' / mem_budget=", 9,
                          "the memory planner")
    if adjoint == "naive":
        raise ValueError(
            "adjoint='naive' (AD through the solver) is impossible for "
            "implicit methods: Newton/GMRES have no reverse rule — the "
            "paper's motivating limitation; use one of "
            f"{IMPLICIT_POLICIES}")
    if adjoint not in IMPLICIT_POLICIES:
        raise ValueError(f"unknown implicit adjoint policy {adjoint!r}; one "
                         f"of {IMPLICIT_POLICIES}")
    if offload not in _OFFLOAD_TIERS:
        raise ValueError(f"unknown offload tier {offload!r}; one of "
                         f"{_OFFLOAD_TIERS}")
    if offload not in (None, "device") or offload_segment is not None \
            or snaps_in_ram is not None or offload_dir is not None \
            or resilient:
        raise _not_ported(
            "offload to the host/spill/disk tiers (offload, "
            "offload_segment, snaps_in_ram, offload_dir, resilient)", 10,
            "the offload tiers")
    if rescue is True:
        rescue = RescueConfig()
    if rescue is not None and not isinstance(rescue, RescueConfig):
        raise ValueError(f"rescue must be a RescueConfig, True, or None; "
                         f"got {rescue!r}")
    if adjoint in ("revolve", "revolve2"):
        ncheck = _validate_ncheck(adjoint, ncheck, n_steps)
    cfg = _SolverConfig(theta, int(newton_iters), float(newton_tol),
                        int(gmres_iters), float(gmres_tol), rescue=rescue)
    solver = _ImplicitSolver(f, cfg, float(t0), float(dt), n_steps, adjoint,
                             ncheck)
    u_final, stats = solver(u0, theta_p)
    return (u_final, stats) if return_stats else u_final


# ---------------------------------------------------------------------------
# mass-matrix path (forward-only)
# ---------------------------------------------------------------------------

def _odeint_implicit_mass(f, mass, t0, dt, n_steps, theta, newton_iters,
                          newton_tol, gmres_iters, gmres_tol, u0, theta_p,
                          return_stats):
    """Mass-matrix path: the mass operator is closed over statically and
    the solve has no adjoint, so it refuses inputs that require a
    gradient."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(x) and x.requires_grad
            for x in pytree.tree_leaves((u0, theta_p, mass))):
        raise ValueError("odeint_implicit(mass=...) is forward-only: its "
                         "inputs must not require a gradient")
    u, stats = u0, _stats_zero()
    with torch.no_grad():
        for n in range(n_steps):
            u, info = implicit_step(f, u, theta_p, t0 + dt * n, dt, theta,
                                    newton_iters, newton_tol, gmres_iters,
                                    gmres_tol, mass=mass)
            stats = _stats_merge(stats, info)
    return (u, stats) if return_stats else u


# ---------------------------------------------------------------------------
# the checkpoint policies: one autograd.Function over the flattened leaves
# ---------------------------------------------------------------------------

def _segment_bounds(n_steps: int, ncheck: int):
    positions = [0] + revolve_mod.sweep_checkpoint_positions(n_steps, ncheck)
    return list(zip(positions, positions[1:] + [n_steps]))


class _ImplicitSolver:
    """Binds one policy's forward and reverse sweeps to the autograd
    Function."""

    def __init__(self, f, cfg, t0, dt, n_steps, policy, ncheck):
        self.f, self.cfg, self.t0, self.dt = f, cfg, t0, dt
        self.n_steps, self.policy, self.ncheck = n_steps, policy, ncheck

    def __call__(self, u0, theta_p):
        u_leaves, self.u_spec = pytree.tree_flatten(u0)
        th_leaves, self.th_spec = pytree.tree_flatten(theta_p)
        self.n_u = len(u_leaves)
        if not (torch.is_grad_enabled() and any(
                torch.is_tensor(x) and x.requires_grad
                for x in u_leaves + th_leaves)):
            # nothing to differentiate: the plain solve, no checkpoints
            with torch.no_grad():
                u_final, stats, _ = self._advance(u0, theta_p, 0, self.n_steps,
                                                  _stats_zero())
            return u_final, stats
        box: list = []
        out = _ImplicitFunction.apply(self, box, *u_leaves, *th_leaves)
        return pytree.tree_unflatten(list(out), self.u_spec), box[0]

    def unflatten(self, leaves):
        return (pytree.tree_unflatten(list(leaves[:self.n_u]), self.u_spec),
                pytree.tree_unflatten(list(leaves[self.n_u:]), self.th_spec))

    def _t(self, n: int) -> float:
        # t0 + dt*n everywhere, so a recomputed segment's times — hence its
        # states — are bitwise the forward sweep's
        return self.t0 + self.dt * n

    def _advance(self, u, theta_p, start, m, stats=None, states=None):
        """Run m implicit steps from u (step indices start..start+m-1),
        appending each pre-step state to ``states`` when given, merging the
        Newton reports into ``stats`` when given."""
        for k in range(m):
            if states is not None:
                states.append(u)
            u, info, resc = _step(self.f, self.cfg, u, theta_p,
                                  self._t(start + k), self.dt)
            if stats is not None:
                stats = _stats_merge(stats, info, resc)
        return u, stats, states

    # -- forward sweeps: (u_final, stats, residuals) --------------------------
    def forward(self, u0, theta_p):
        n, p = self.n_steps, self.policy
        if p == "pnode":
            u_final, stats, states = self._advance(u0, theta_p, 0, n,
                                                   _stats_zero(), [])
            return u_final, stats, (states, u_final)
        # revolve and revolve2: the forward sweep's checkpoints are the
        # segment boundaries
        store: dict = {}
        u, stats = u0, _stats_zero()
        for a, b in _segment_bounds(n, self.ncheck):
            store[a] = u
            u, stats, _ = self._advance(u, theta_p, a, b - a, stats)
        return u, stats, (store, u)

    # -- reverse sweeps: (lam, mu) ----------------------------------------------
    def backward(self, res, theta_p, g):
        f, cfg, dt = self.f, self.cfg, self.dt
        lam, mu = g, tree_zeros_like(theta_p)

        def adjoint(lam, mu, u_n, u_next, n):
            lam, th_bar = _adjoint_step(f, cfg, u_n, u_next, theta_p,
                                        self._t(n), dt, lam)
            return lam, tree_add(mu, th_bar)

        if self.policy == "pnode":
            states, u_final = res
            u_nexts = states[1:] + [u_final]
            for k in reversed(range(self.n_steps)):
                lam, mu = adjoint(lam, mu, states[k], u_nexts[k], k)
                states[k] = None  # free as the sweep passes
            return lam, mu

        store, u_final = res
        if self.policy == "revolve":
            # the schedule adjoints steps in strictly decreasing order, so
            # u_{n+1} for the step about to be adjointed is always the
            # previous adjoint's checkpoint (u_final initially)
            u_next = u_final
            for act in revolve_mod.reverse_schedule(self.n_steps,
                                                    self.ncheck):
                kind = act[0]
                if kind == "advance":
                    _, start, m = act
                    u, _, _ = self._advance(store[start], theta_p, start, m)
                    store[start + m] = u
                elif kind == "adjoint":
                    _, idx = act
                    u_i = store.pop(idx)
                    lam, mu = adjoint(lam, mu, u_i, u_next, idx)
                    u_next = u_i
                elif kind == "free":
                    store.pop(act[1], None)
                else:  # pragma: no cover
                    raise ValueError(act)
            return lam, mu

        # revolve2: re-advance each segment once, saving its states
        for a, b in reversed(_segment_bounds(self.n_steps, self.ncheck)):
            u_b, _, states = self._advance(store.pop(a), theta_p, a, b - a,
                                           states=[])
            u_nexts = states[1:] + [u_b]
            for k in reversed(range(b - a)):
                lam, mu = adjoint(lam, mu, states[k], u_nexts[k], a + k)
        return lam, mu


class _ImplicitFunction(torch.autograd.Function):
    """Custom gradient of one implicit checkpoint policy.  Inputs are the
    flattened leaves of u0 then theta_p; outputs the leaves of u_final."""

    @staticmethod
    def forward(ctx, solver: _ImplicitSolver, box: list, *leaves):
        u0, theta_p = solver.unflatten(
            [x.detach() if torch.is_tensor(x) else x for x in leaves])
        u_final, stats, res = solver.forward(u0, theta_p)
        box.append(stats)
        ctx.solver, ctx.res, ctx.theta_p = solver, res, theta_p
        return tuple(pytree.tree_leaves(u_final))

    @staticmethod
    def backward(ctx, *g_leaves):
        solver, res, theta_p = ctx.solver, ctx.res, ctx.theta_p
        ctx.res = ctx.theta_p = None  # one reverse sweep consumes them
        if res is None:
            raise RuntimeError("odeint_implicit's reverse sweep ran twice; "
                               "its checkpoints are consumed by the first")
        g = pytree.tree_unflatten(list(g_leaves), solver.u_spec)
        lam, mu = solver.backward(res, theta_p, g)
        return (None, None,
                *(x.detach() for x in pytree.tree_leaves((lam, mu))))
