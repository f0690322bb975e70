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

``ImplicitSolver`` runs a solve in one of two forms.  The eager route
(``capture=False, lanes=False``; what ``odeint_implicit`` builds) reads
the Newton and GMRES exits on the host, one device-to-host read per
iteration.  The masked form writes every exit as a per-lane device mask
and freezes a finished iterate with ``torch.where``: the solve becomes a
sequence of units (one GMRES cycle each) that read nothing on the host, so
each unit can be captured as a CUDA graph (``capture=True``), and a lane
axis gives each of B independent systems its own Newton and GMRES loops
(``lanes=True``, the port's counterpart of ``jax.vmap(odeint_implicit)``).
The host reads one 0-d ``live`` flag every ``CHECK_EVERY`` units.  On one
lane the masked form is bitwise the eager route.
``odeint_implicit(..., return_stats=True)`` returns ``(u_final,
ImplicitStats)``: ``diverged`` is True if any step exhausted
``newton_iters`` with residual > ``newton_tol``.

``odeint_implicit(adjoint="auto", mem_budget=...)`` picks the policy
and ``ncheck`` through the memory planner (``repro_torch.mem.planner``),
which forwards the Newton and GMRES settings to its cost model and its
measured check.

``offload=`` moves the checkpoints off the device on the eager route
(``repro_torch.mem.offload``): pnode with "spill" or "disk" ships the
converged states a segment at a time (``offload_segment`` steps, default
ceil(sqrt(N_t))) from a device staging buffer and reads them back one
segment per ``prefetch``, newest first; revolve and revolve2 put their
checkpoints through a store's slots ("host", "spill" or "disk").
``resilient=True`` (pnode with spill/disk) checksums each slot and keeps
each segment's entry state on the device: a segment whose checked read
fails is integrated again from that state, bitwise the lost one.

On the eager route ``obs=`` (a ``repro_torch.obs.FlightRecorder``)
records ``implicit.solve``, one ``implicit.steps`` event a forward sweep
(the stacked Newton exits: iterations, residual, converged),
``implicit.recompute`` for the reverse sweep's re-advances,
``implicit.rescue`` when a rescue or a fault plan is armed, and
``spill.recover`` (with ``ok``) for each checked segment of the resilient
route, from the exits the host reads anyway; it is bound to the
checkpoint store.  ``fault_plan=`` (a ``repro_torch.ft.FaultPlan``)
poisons the exit of the first Newton attempt of the steps its ``newton``
specs cover (``nan``/``inf`` the state, ``diverge`` the converged flag),
keyed by the absolute step index, so a reverse sweep's recompute fires
them again; with ``rescue`` the retries recover the fault-free bits.  The
plan also arms the store's spill sites and walks the tier ladder.

Not ported (they raise ``NotImplementedError``): offload in the masked
form (``capture=True`` or ``lanes=True``; ROADMAP Queue 1 item 10a),
``obs=``/``fault_plan=`` in the masked form (item 11a), and
``rescue=``/``mass=`` in the masked form (item 7c).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import revolve as revolve_mod
from repro_torch.core.adaptive import CHECK_EVERY
from repro_torch.core.adjoint import OFFLOAD_TIERS, _validate_ncheck
from repro_torch.core.adjoint import _validate_offload as _validate_tier_knobs
from repro_torch.core.adjoint import not_ported
from repro_torch.core.gmres import GmresCarry, gmres
from repro_torch.core.gmres import _norm as _lane_norm
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
from repro_torch.launch.graphs import StepGraph
from repro_torch.obs.profile import scope

IMPLICIT_METHODS = ("beuler", "cn")
IMPLICIT_POLICIES = ("pnode", "revolve", "revolve2")


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
    fault: object = None     # repro_torch.ft.FaultPlan | None


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


def _rescued_step(f, cfg: _SolverConfig, u, theta_p, t_n, h, idx: int):
    """One implicit step under fault injection and/or divergence rescue.
    Attempt 0 runs at the configured iteration cap; the plan's ``newton``
    faults at step ``idx`` poison its exit (``nan``/``inf`` the state and
    residual, ``diverge`` the converged flag), not f.  A failed attempt
    (not converged, or a non-finite state) falls through ``max_retries``
    retries at escalated Newton caps — bit-identical to the fault-free
    step whenever that would have converged, because the Newton loop
    exits on residual <= tol — then optionally two h/2 sub-steps as a
    non-bitwise last resort.  Returns ``(u_next, StepInfo, rescued)``,
    ``rescued`` 1 when the accepted result came from a retry or the
    halving."""
    rescue = cfg.rescue if cfg.rescue is not None else \
        RescueConfig(max_retries=0, escalate=1, dt_halving=False)
    fault = cfg.fault
    gate = ((lambda kind: fault.traced_gate("newton", kind, idx))
            if fault is not None else (lambda kind: False))
    bad_nan, bad_inf, forced = gate("nan"), gate("inf"), gate("diverge")

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
        if i == 0 and (bad_nan or bad_inf):
            fill = math.nan if bad_nan else math.inf
            u1 = tree_map(lambda x: torch.full_like(x, fill), u1)
            info = info._replace(residual=fill)
        if i == 0 and forced:
            info = info._replace(converged=False)
        ok = info.converged and _tree_allfinite(u1)
        if ok or i == len(makers) - 1:
            return u1, info, int(ok and i > 0)


def _step(f, cfg: _SolverConfig, u, theta_p, t_n, h, idx: int):
    """Step ``idx``.  Returns ``(u_next, StepInfo, rescued)``."""
    if cfg.rescue is None and cfg.fault is None:
        u_next, info = implicit_step(f, u, theta_p, t_n, h, cfg.theta,
                                     cfg.newton_iters, cfg.newton_tol,
                                     cfg.gmres_iters, cfg.gmres_tol)
        return u_next, info, 0
    return _rescued_step(f, cfg, u, theta_p, t_n, h, idx)


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

def _mass_refusal() -> ValueError:
    return ValueError(
        "mass-matrix solves support only the default dense path "
        "(adjoint='pnode', no offload/mem_budget and no "
        "rescue/fault_plan/resilient): "
        "the mass operator is closed over statically and the solve is "
        "forward-only")


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
    ``revolve`` / ``revolve2``, with ``ncheck`` slots for the last two;
    ``auto`` + ``mem_budget=<bytes>`` delegates to the memory planner,
    ``mem_verify`` as ``odeint`` takes it).
    Differentiable w.r.t. the tensor leaves of ``u0`` and ``theta_p``.
    ``return_stats=True`` returns ``(u_final, ImplicitStats)`` so Newton
    non-convergence surfaces as ``stats.diverged`` instead of silently
    wrong states and gradients.  ``rescue=`` a ``RescueConfig`` (or
    ``True`` for the defaults) retries a failed step at escalated Newton
    caps, then optionally as two half steps; ``stats.rescued`` counts the
    rescued steps.  ``mass=`` (a matrix or a callable) solves
    M u' = f, forward only.  ``t0``/``dt`` are Python floats; step n starts
    at ``t0 + dt * n``.  One eager solve (an ``ImplicitSolver`` with
    ``capture=False, lanes=False``); a caller that solves again and again
    keeps an ``ImplicitSolver``.  ``obs`` and ``fault_plan`` are the module
    docstring's; it lists the options that are not ported."""
    if mass is not None and (offload is not None or mem_budget is not None
                             or resilient or fault_plan is not None):
        raise _mass_refusal()
    from_auto = adjoint == "auto"
    if from_auto:
        from repro_torch.mem.planner import plan_odeint  # late: import cycle
        plan = plan_odeint(
            f, u0, theta_p, dt=float(dt), n_steps=int(n_steps), t0=float(t0),
            method=method, mem_budget=mem_budget, verify=mem_verify,
            solver_opts=dict(newton_iters=int(newton_iters),
                             newton_tol=float(newton_tol),
                             gmres_iters=int(gmres_iters),
                             gmres_tol=float(gmres_tol)))
        adjoint, ncheck = plan.policy, plan.ncheck
        offload = plan.offload if plan.offload is not None else offload
        if plan.snaps_in_ram is not None and snaps_in_ram is None:
            snaps_in_ram = plan.snaps_in_ram
    elif mem_budget is not None:
        raise ValueError(
            "mem_budget is only meaningful with adjoint='auto' (the planner "
            f"chooses the policy); got adjoint={adjoint!r}")
    solver = ImplicitSolver(f, dt=dt, n_steps=n_steps, t0=t0, method=method,
                            adjoint=adjoint, ncheck=ncheck,
                            newton_iters=newton_iters, newton_tol=newton_tol,
                            gmres_iters=gmres_iters, gmres_tol=gmres_tol,
                            mass=mass, rescue=rescue, offload=offload,
                            offload_segment=offload_segment,
                            snaps_in_ram=snaps_in_ram,
                            offload_dir=offload_dir, resilient=resilient,
                            obs=obs, fault_plan=fault_plan)
    solver.planned = from_auto
    u_final, stats = solver(u0, theta_p)
    return (u_final, stats) if return_stats else u_final


# ---------------------------------------------------------------------------
# mass-matrix path (forward-only)
# ---------------------------------------------------------------------------

def _odeint_implicit_mass(f, mass, t0, dt, n_steps, theta, newton_iters,
                          newton_tol, gmres_iters, gmres_tol, u0, theta_p):
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
    return u, stats


# ---------------------------------------------------------------------------
# the solver: checkpoint policies over one autograd Function, run eagerly or
# as masked units (captured, and on a lane axis)
# ---------------------------------------------------------------------------

class _Spilled(NamedTuple):
    """pnode's residual on the spill/disk tiers: the store, and each
    segment's entry state by its first step (``resilient`` only)."""
    store: object
    starts: dict


def _validate_offload(adjoint, offload, offload_segment, snaps_in_ram,
                      offload_dir, resilient):
    """The JAX package's checks of the offload knobs of
    ``odeint_implicit``: ``odeint``'s, and ``resilient`` only with pnode on
    spill/disk (its ``ValueError``s, with the same meaning).  Returns
    (offload_segment, snaps_in_ram) as ints or None."""
    if offload not in OFFLOAD_TIERS:
        raise ValueError(f"unknown offload tier {offload!r}; one of "
                         f"{OFFLOAD_TIERS}")
    if resilient and not (adjoint == "pnode"
                          and offload in ("spill", "disk")):
        raise ValueError(
            "resilient=True (checked prefetch + recompute fallback) applies "
            "to the segmented spill paths (adjoint='pnode', "
            f"offload='spill'/'disk'); got adjoint={adjoint!r}, "
            f"offload={offload!r}")
    return _validate_tier_knobs(adjoint, offload, offload_segment,
                                snaps_in_ram, offload_dir, None)


def _segment_bounds(n_steps: int, ncheck: int):
    positions = [0] + revolve_mod.sweep_checkpoint_positions(n_steps, ncheck)
    return list(zip(positions, positions[1:] + [n_steps]))


class _Layout:
    """A state pytree as a (B, n) block of lanes and back.  With lanes,
    every leaf has the leading lane axis B; without, B = 1 and the leaves
    are flattened as ``gmres`` flattens them."""

    def __init__(self, leaves, spec, lanes: bool):
        self.spec, self.lanes = spec, lanes
        self.B = leaves[0].shape[0] if lanes else 1
        self.shapes = [tuple(x.shape[1:]) if lanes else tuple(x.shape)
                       for x in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.n = sum(self.sizes)

    def flat(self, tree) -> torch.Tensor:
        return torch.cat([x.reshape(self.B, -1)
                          for x in pytree.tree_leaves(tree)], dim=1)

    def unflat(self, v: torch.Tensor):
        if self.lanes:
            parts = [p.reshape((self.B,) + s) for p, s in
                     zip(torch.split(v, self.sizes, dim=1), self.shapes)]
        else:
            parts = [p.view(s) for p, s in
                     zip(torch.split(v[0], self.sizes), self.shapes)]
        return pytree.tree_unflatten(parts, self.spec)

    def norm(self, tree) -> torch.Tensor:
        """Per-lane 2-norm (B,); without lanes ``tree_norm``, as the eager
        Newton loop takes it."""
        if self.lanes:
            return _lane_norm(self.flat(tree))
        return tree_norm(tree).reshape(1)


class ImplicitSolver:
    """The implicit theta-method solve for one vector field, with its
    buffers (and, with ``capture=True``, its CUDA graphs) kept across
    calls.  ``solver(u0, theta)`` returns ``(u_final, ImplicitStats)`` and
    is differentiable w.r.t. the tensor leaves of ``u0`` and ``theta``
    through the discrete adjoint of the chosen policy (``pnode``,
    ``revolve``, ``revolve2``).  The other arguments are
    ``odeint_implicit``'s.

    ``capture=False, lanes=False`` is the eager route: Newton's and
    GMRES's exits are read on the host at every iteration.  Otherwise the
    solve runs as masked units in static buffers.  A unit is one GMRES
    cycle (``core/gmres.py::GmresCarry``); a lane whose GMRES exits in it
    also takes the Newton update and its exit residual and, if its Newton
    loop goes on, starts its next residual and GMRES.  A step begins with
    one start unit (f(u_n), the predictor and the first residual).  The
    reverse sweep has the same form: a start unit, transposed-GMRES cycles,
    and a finish unit (lambda_n and the theta increment).  The host reads
    one 0-d ``live`` flag every ``CHECK_EVERY`` units and nothing else
    during a solve; the stats are accumulated on the device and read once
    a solve.  ``capture=True`` captures each unit as a CUDA graph
    (``launch.graphs.StepGraph``) and replays it; on CPU tensors it runs
    the same functions eagerly.  A masked solve is bitwise the eager
    route's on one device (the same operations in the same order; a
    finished lane is frozen by ``torch.where``).  ``f`` receives ``t`` as
    a 0-d float64 tensor on the state's device there, a Python float on
    the eager route.

    ``lanes=True`` is the port's counterpart of
    ``jax.vmap(odeint_implicit)``: every leaf of ``u0`` carries a leading
    lane axis B, and ``f`` is lane-separable (row i of ``f(u, theta, t)``
    depends only on row i of ``u`` and on lane i of ``theta``, or on a
    shared ``theta``).  Each lane has its own Newton and GMRES loops and
    exits, as ``jax.vmap`` of the reference's ``while_loop``s gives them;
    the lanes share a step, as under ``vmap`` of its ``scan``.
    ``ImplicitStats`` then holds per-lane tensors (B,), which are not read
    on the host.  Gradients come out per lane for per-lane ``theta``
    leaves and summed over lanes for a shared one.  ``torch.func.vmap``
    cannot map a data-dependent loop, hence the explicit lane axis.

    Every call copies ``theta`` into the static buffers: u0 and theta must
    keep their structure, shapes, dtypes and device across calls.  With
    the masked units the buffers hold the last call, so the reverse sweep
    of a call that was followed by another call raises; keep one solver
    per call site of a loss.  ``rescue=`` and ``mass=`` run only on the
    eager route (ROADMAP Queue 1 item 7c), and so do ``offload``,
    ``offload_segment``, ``snaps_in_ram``, ``offload_dir`` and
    ``resilient`` (``odeint_implicit``'s; item 10a), and ``obs`` and
    ``fault_plan`` (item 11a).
    """

    def __init__(self, f: VectorField, *, dt: float, n_steps: int,
                 t0: float = 0.0, method: str = "cn",
                 adjoint: str = "pnode", ncheck: int | None = None,
                 newton_iters: int = 10, newton_tol: float = 1e-9,
                 gmres_iters: int = 20, gmres_tol: float = 1e-10,
                 mass=None, rescue=None, capture: bool = False,
                 lanes: bool = False, offload: str | None = None,
                 offload_segment: int | None = None,
                 snaps_in_ram: int | None = None,
                 offload_dir: str | None = None, resilient: bool = False,
                 obs=None, fault_plan=None):
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        theta = _theta_of(method)
        if mass is not None and (adjoint != "pnode" or rescue is not None
                                 or offload is not None or resilient
                                 or fault_plan is not None):
            raise _mass_refusal()
        if adjoint == "naive":
            raise ValueError(
                "adjoint='naive' (AD through the solver) is impossible for "
                "implicit methods: Newton/GMRES have no reverse rule — the "
                "paper's motivating limitation; use one of "
                f"{IMPLICIT_POLICIES}")
        if adjoint not in IMPLICIT_POLICIES:
            raise ValueError(f"unknown implicit adjoint policy {adjoint!r}; "
                             f"one of {IMPLICIT_POLICIES}")
        if rescue is True:
            rescue = RescueConfig()
        if rescue is not None and not isinstance(rescue, RescueConfig):
            raise ValueError(f"rescue must be a RescueConfig, True, or None; "
                             f"got {rescue!r}")
        offload_segment, snaps_in_ram = _validate_offload(
            adjoint, offload, offload_segment, snaps_in_ram, offload_dir,
            resilient)
        self.masked = bool(capture) or bool(lanes)
        if self.masked and (rescue is not None or mass is not None):
            raise not_ported(
                "ImplicitSolver", "rescue= / mass= with lanes=True or "
                "capture=True", "7c", "the masked Newton loop's rescue "
                "retries and mass matrix")
        if self.masked and offload in ("host", "spill", "disk"):
            raise not_ported(
                "ImplicitSolver", f"offload={offload!r} with lanes=True or "
                "capture=True", "10a", "offload in the masked implicit "
                "form and under lanes")
        if self.masked and (obs is not None or fault_plan is not None):
            raise not_ported(
                "ImplicitSolver", "obs= / fault_plan= with lanes=True or "
                "capture=True", "11a", "a per-step device log of the "
                "Newton exits and per-lane Newton gates in the masked form")
        if fault_plan is not None and offload in ("host", "spill", "disk"):
            # a downed tier walks the degradation ladder before the store
            # is built, so the solve runs on a healthy tier
            from repro_torch.mem.offload import effective_tier
            eff = effective_tier(offload, fault_plan,
                                 scanned=adjoint == "pnode", obs=obs)
            if eff != offload:
                offload = eff
                if offload not in ("spill", "disk"):
                    offload_segment = snaps_in_ram = offload_dir = None
                resilient = resilient and offload in ("spill", "disk")
        if adjoint in ("revolve", "revolve2"):
            ncheck = _validate_ncheck(adjoint, ncheck, n_steps)
        #: checkpoint tier and its knobs (``repro_torch.mem.offload``)
        self.offload = offload
        self.store_kw = dict(snaps_in_ram=snaps_in_ram, disk_dir=offload_dir)
        self.resilient = bool(resilient)
        self.segment = None
        if adjoint == "pnode" and offload in ("spill", "disk"):
            from repro_torch.mem.offload import default_segment
            self.segment = min(offload_segment if offload_segment is not None
                               else default_segment(n_steps), n_steps)
        self.f = f
        self.cfg = _SolverConfig(theta, int(newton_iters), float(newton_tol),
                                 int(gmres_iters), float(gmres_tol),
                                 rescue=rescue, fault=fault_plan)
        self.method, self.obs, self.fault_plan = method, obs, fault_plan
        #: the policy came from the memory planner (``implicit.solve``)
        self.planned = False
        self.t0, self.dt = float(t0), float(dt)
        self.n_steps, self.policy, self.ncheck = n_steps, adjoint, ncheck
        self.mass = mass
        self.capture, self.lanes = bool(capture), bool(lanes)
        self._layout = None
        self._graphs: dict = {}
        #: bumped by every forward pass of the masked units
        self.generation = 0
        #: units replayed (or run, when not captured) and ``live`` reads,
        #: over the solver's life; the caller takes differences
        self.replays = 0
        self.live_reads = 0
        self.stats_reads = 0

    # -- arguments -------------------------------------------------------------
    def _bind(self, u_leaves, th_leaves, u_spec, th_spec) -> None:
        layout = (u_spec, th_spec,
                  [(x.shape, x.dtype, x.device) for x in u_leaves],
                  [(getattr(x, "shape", None), getattr(x, "dtype", None),
                    getattr(x, "device", None)) for x in th_leaves])
        if self._layout is not None:
            if layout != self._layout:
                raise ValueError(
                    "ImplicitSolver: u0/theta differ in structure, shape, "
                    "dtype or device from the first call; build a new "
                    "solver for them")
            return
        self._layout = layout
        self.u_spec, self.th_spec, self.n_u = u_spec, th_spec, len(u_leaves)
        if not self.masked:
            return
        if not all(torch.is_tensor(x) for x in u_leaves + th_leaves):
            raise TypeError("ImplicitSolver: with capture=True or lanes=True "
                            "every leaf of u0 and theta must be a tensor")
        devices = {x.device for x in u_leaves + th_leaves}
        if len(devices) != 1:
            raise ValueError("ImplicitSolver: u0 and theta must lie on one "
                             f"device, got {sorted(map(str, devices))}")
        dtypes = {x.dtype for x in u_leaves}
        if len(dtypes) != 1:
            raise ValueError("ImplicitSolver: the leaves of u0 must share "
                             f"one dtype, got {sorted(map(str, dtypes))}")
        if self.lanes and (any(x.dim() == 0 for x in u_leaves)
                           or len({x.shape[0] for x in u_leaves}) != 1):
            raise ValueError("ImplicitSolver(lanes=True): every leaf of u0 "
                             "needs the same leading lane axis")
        self._alloc(u_leaves, th_leaves, devices.pop())

    def _alloc(self, u_leaves, th_leaves, device) -> None:
        lay = self._lay = _Layout(u_leaves, self.u_spec, self.lanes)
        block = torch.zeros(lay.B, lay.n, dtype=u_leaves[0].dtype,
                            device=device)
        lane = dict(device=device)
        time = dict(dtype=torch.float64, device=device)
        self._restart = min(20, lay.n)      # gmres's default, capped at n
        self._th = [torch.zeros_like(x) for x in th_leaves]
        self._u, self._v, self._g = (block.clone() for _ in range(3))
        self._rnorm = torch.zeros(lay.B, dtype=block.dtype, **lane)
        self._it = torch.zeros(lay.B, dtype=torch.int64, **lane)
        self._nlive = torch.zeros(lay.B, dtype=torch.bool, **lane)
        self._live = torch.zeros((), dtype=torch.bool, **lane)
        self._t = torch.zeros((), **time)
        self._tn = torch.zeros((), **time)
        self._diverged = torch.zeros(lay.B, dtype=torch.bool, **lane)
        self._maxres = torch.zeros(lay.B, dtype=block.dtype, **lane)
        self._iters = torch.zeros(lay.B, dtype=torch.int64, **lane)
        self._gm = GmresCarry(block)
        self._un, self._unext, self._lam = (block.clone() for _ in range(3))
        self._mu = [torch.zeros_like(x) for x in th_leaves]
        self._agm = GmresCarry(block)
        self._held = (self._th, self._u, self._v, self._g, self._rnorm,
                      self._it, self._nlive, self._live, self._t, self._tn,
                      self._diverged, self._maxres, self._iters,
                      self._gm.tensors(), self._un, self._unext, self._lam,
                      self._mu, self._agm.tensors())

    def _time(self, n: int) -> float:
        # t0 + dt*n everywhere, so a recomputed segment's times — hence its
        # states — are bitwise the forward sweep's
        return self.t0 + self.dt * n

    # -- call ------------------------------------------------------------------
    def __call__(self, u0: PyTree, theta_p: PyTree):
        u_leaves, u_spec = pytree.tree_flatten(u0)
        th_leaves, th_spec = pytree.tree_flatten(theta_p)
        self._bind(u_leaves, th_leaves, u_spec, th_spec)
        cfg = self.cfg
        if self.mass is not None:
            return _odeint_implicit_mass(
                self.f, self.mass, self.t0, self.dt, self.n_steps, cfg.theta,
                cfg.newton_iters, cfg.newton_tol, cfg.gmres_iters,
                cfg.gmres_tol, u0, theta_p)
        if torch.is_grad_enabled() and any(
                torch.is_tensor(x) and x.requires_grad
                for x in u_leaves + th_leaves):
            box: list = []
            out = _ImplicitFunction.apply(self, box, *u_leaves, *th_leaves)
            return pytree.tree_unflatten(list(out), u_spec), box[0]
        # nothing to differentiate: the plain solve, no checkpoints
        with torch.no_grad():
            out, stats, _ = self.forward_leaves(u_leaves, th_leaves,
                                                record=False)
        return pytree.tree_unflatten(list(out), u_spec), stats

    def forward_leaves(self, u_leaves, th_leaves, record: bool):
        """(u_final leaves, stats, residuals of the reverse sweep)."""
        th_leaves = list(th_leaves)
        theta_p = pytree.tree_unflatten(th_leaves, self.th_spec)
        u0 = pytree.tree_unflatten(list(u_leaves), self.u_spec)
        if not self.masked:
            self._record_solve()
            with scope(f"{self._scope}/fwd"):
                if record:
                    u, stats, res = self.forward(u0, theta_p)
                else:
                    u, stats, _ = self._advance(u0, theta_p, 0,
                                                self.n_steps, _stats_zero(),
                                                kind="implicit.steps")
                    res = None
            return pytree.tree_leaves(u), stats, (res, theta_p)
        # a later call overwrites the buffers an earlier reverse sweep reads
        self.generation += 1
        if self.capture:
            self._capture(("start", "unit"))
        for buf, x in zip(self._th, th_leaves):
            buf.copy_(x)
        for buf in (self._diverged, self._maxres, self._iters):
            buf.zero_()
        u0 = self._lay.flat(u0)
        if record:
            u, _, res = self.forward(u0, None)
        else:
            u, _, _ = self._advance(u0, None, 0, self.n_steps)
            res = None
        stats = self._read_stats()
        if record and self.capture:
            # captured here, on the caller's thread, not inside autograd's
            # backward; their warm-ups write lam, mu and the adjoint GMRES,
            # which the reverse sweep resets
            self._capture(("adj_start", "adj_unit", "adj_finish"))
        return pytree.tree_leaves(self._lay.unflat(u)), stats, res

    def backward_leaves(self, res, g_leaves):
        g = pytree.tree_unflatten(list(g_leaves), self.u_spec)
        if not self.masked:
            res, theta_p = res
            with scope(f"{self._scope}/bwd"):
                return pytree.tree_leaves(self.backward(res, theta_p, g))
        lam, mu = self.backward(res, None, self._lay.flat(g))
        return (pytree.tree_leaves(self._lay.unflat(lam.clone()))
                + [x.clone() for x in mu])

    def make_store(self, integrity: bool = False):
        from repro_torch.mem.offload import make_store  # late: import cycle
        store = make_store(self.offload, integrity=integrity,
                           fault_plan=self.fault_plan, **self.store_kw)
        if self.obs is not None:
            store.bind_obs(self.obs)
        return store

    # -- the flight recorder (eager route) --------------------------------------
    @property
    def _scope(self) -> str:
        """The sweeps' profiler frames, the JAX package's names."""
        if self.policy != "pnode":
            return f"imp_{self.policy}"
        return "imp_spill" if self.segment is not None else "implicit"

    def _record_solve(self) -> None:
        if self.obs is None:
            return
        extra = {}
        if self.cfg.rescue is not None:
            extra["rescue"] = True
        if self.fault_plan is not None:
            extra["faulted"] = True
        if self.resilient:
            extra["resilient"] = True
        self.obs.record("implicit.solve", method=self.method,
                        adjoint=self.policy, n_steps=self.n_steps,
                        dt=self.dt, t0=self.t0,
                        ncheck=None if self.ncheck is None
                        else int(self.ncheck),
                        offload=self.offload,
                        newton_iters=self.cfg.newton_iters,
                        gmres_iters=self.cfg.gmres_iters,
                        planned=self.planned, **extra)

    def _record_steps(self, kind: str, base: int, infos,
                      rescue: bool = True) -> None:
        """One stacked event of the exits ``infos`` ((StepInfo, rescued) a
        step, from step ``base``), and the rescue flags when a rescue or a
        fault plan is armed."""
        if self.obs is None:
            return
        self.obs.record(kind, _runtime=True, base=base,
                        iters=[int(i.iters) for i, _ in infos],
                        residual=[float(i.residual) for i, _ in infos],
                        converged=[bool(i.converged) for i, _ in infos])
        if rescue and (self.cfg.rescue is not None
                       or self.fault_plan is not None):
            self.obs.record("implicit.rescue", _runtime=True, base=base,
                            rescued=[int(r) for _, r in infos])

    # -- forward sweeps: (u_final, stats, residuals) ---------------------------
    def forward(self, u0, theta_p):
        n, p = self.n_steps, self.policy
        if p == "pnode" and self.segment is not None:
            return self._spill_forward(u0, theta_p)
        if p == "pnode":
            u_final, stats, states = self._advance(u0, theta_p, 0, n,
                                                   _stats_zero(), [],
                                                   kind="implicit.steps")
            return u_final, stats, (states, u_final)
        # revolve and revolve2: the forward sweep's checkpoints are the
        # segment boundaries
        store = self.make_store()
        u, stats = u0, _stats_zero()
        for a, b in _segment_bounds(n, self.ncheck):
            store.put(a, u)
            u, stats, _ = self._advance(u, theta_p, a, b - a, stats,
                                        kind="implicit.steps", rescue=False)
        return u, stats, (store, u)

    def _spill_forward(self, u0, theta_p):
        """pnode on the spill/disk tiers: each pre-step state is copied into
        slot i of a device staging buffer, and each segment goes to the
        store in one ``write_batch``; ``resilient`` keeps each segment's
        entry state on the device."""
        from repro_torch.mem.offload import wait_copy
        n, seg = self.n_steps, self.segment
        store = self.make_store(integrity=self.resilient)
        u, stats, staging, event, starts = u0, _stats_zero(), None, None, {}
        log = []
        for base in range(0, n, seg):
            m = min(seg, n - base)
            if self.resilient:
                starts[base] = u
            for i in range(m):
                if staging is None:
                    staging = tree_map(
                        lambda x: x.new_empty((seg,) + tuple(x.shape)), u)
                if i == 0:
                    wait_copy(event)
                for buf, x in zip(pytree.tree_leaves(staging),
                                  pytree.tree_leaves(u)):
                    buf[i].copy_(x)
                u, stats, _ = self._advance(u, theta_p, base + i, 1, stats,
                                            log=log)
            event = store.write_batch(base, tree_map(lambda b: b[:m],
                                                     staging))
        if self.obs is not None:
            # the JAX package's stacked events: the full segments, then the
            # rest, and the solve's rescue count
            n_full = n // seg * seg
            for a, b in ((0, n_full), (n_full, n)):
                if b > a:
                    self._record_steps("implicit.steps", a, log[a:b],
                                       rescue=False)
            if self.cfg.rescue is not None or self.fault_plan is not None:
                self.obs.record("implicit.rescue", _runtime=True, base=0,
                                rescued=stats.rescued)
        return u, stats, (_Spilled(store, starts), u)

    # -- reverse sweeps: (lam, mu) ---------------------------------------------
    def backward(self, res, theta_p, g):
        if self.masked:
            self._lam.copy_(g)
            for buf in self._mu:
                buf.zero_()
            lam, mu = self._lam, self._mu
        else:
            lam, mu = g, tree_zeros_like(theta_p)

        def adjoint(lam, mu, u_n, u_next, n):
            return self._adjoint(lam, mu, u_n, u_next, theta_p, n)

        if self.policy == "pnode" and self.segment is not None:
            spilled, u_final = res
            return self._spill_backward(spilled, u_final, theta_p, lam, mu,
                                        adjoint)
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
                    u, _, _ = self._advance(store.get(start), theta_p, start,
                                            m, kind="implicit.recompute",
                                            rescue=False)
                    store.put(start + m, u)
                elif kind == "adjoint":
                    _, idx = act
                    u_i = store.pop(idx)
                    lam, mu = adjoint(lam, mu, u_i, u_next, idx)
                    u_next = u_i
                elif kind == "free":
                    store.free(act[1])
                else:  # pragma: no cover
                    raise ValueError(act)
            return lam, mu

        # revolve2: re-advance each segment once, saving its states
        for a, b in reversed(_segment_bounds(self.n_steps, self.ncheck)):
            u_b, _, states = self._advance(store.pop(a), theta_p, a, b - a,
                                           states=[],
                                           kind="implicit.recompute")
            u_nexts = states[1:] + [u_b]
            for k in reversed(range(b - a)):
                lam, mu = adjoint(lam, mu, states[k], u_nexts[k], a + k)
        return lam, mu

    def _spill_backward(self, spilled, u_final, theta_p, lam, mu, adjoint):
        """The reverse sweep over the stored segments, newest first: one
        ``prefetch`` a segment, the next one's read issued right after.
        ``resilient``: a checked read instead, and a segment that fails it
        is integrated again from its entry state (the same steps in the
        same order, so the same states bitwise)."""
        store, starts = spilled
        n, seg = self.n_steps, self.segment
        n_full, rem = divmod(n, seg)
        if not rem and n_full and not self.resilient:
            store.prefetch_issue((n_full - 1) * seg, seg)
        u_next = u_final
        for base in reversed(range(0, n, seg)):
            m = min(seg, n - base)
            if self.resilient:
                ok, stacked = store.prefetch_checked(base, m)
                if self.obs is not None:
                    self.obs.record("spill.recover", _runtime=True,
                                    base=base, ok=bool(ok))
                if ok:
                    states = [tree_map(lambda b: b[i], stacked)
                              for i in range(m)]
                else:
                    _, _, states = self._advance(starts[base], theta_p, base,
                                                 m, states=[])
            else:
                stacked = store.prefetch(base, m)
                if base - seg >= 0:
                    store.prefetch_issue(base - seg, seg)
                states = [tree_map(lambda b: b[i], stacked)
                          for i in range(m)]
            u_nexts = states[1:] + [u_next]
            for k in reversed(range(m)):
                lam, mu = adjoint(lam, mu, states[k], u_nexts[k], base + k)
            u_next = states[0]
        return lam, mu

    # -- the two primitives the sweeps run -------------------------------------
    def _advance(self, u, theta_p, start, m, stats=None, states=None,
                 kind=None, rescue=True, log=None):
        """Run m implicit steps from u (step indices start..start+m-1),
        appending each pre-step state to ``states`` when given.  Eagerly,
        the Newton reports are merged into ``stats`` when given, appended
        to ``log`` when given, and recorded as one ``kind`` event (with
        the rescue flags when ``rescue``) when a recorder is attached; the
        masked units merge them on the device (read after the forward
        sweep)."""
        if not self.masked:
            infos = []
            for k in range(m):
                if states is not None:
                    states.append(u)
                u, info, resc = _step(self.f, self.cfg, u, theta_p,
                                      self._time(start + k), self.dt,
                                      start + k)
                infos.append((info, resc))
                if stats is not None:
                    stats = _stats_merge(stats, info, resc)
            if log is not None:
                log.extend(infos)
            if kind is not None:
                self._record_steps(kind, start, infos, rescue)
            return u, stats, states
        self._u.copy_(u)
        for k in range(m):
            if states is not None:
                states.append(self._u.clone())
            self._set_times(start + k)
            self._run("start")
            self._loop("unit")
        return self._u.clone(), stats, states

    def _adjoint(self, lam, mu, u_n, u_next, theta_p, n):
        """The adjoint of step n: (lam_n, mu + theta increment)."""
        if not self.masked:
            lam, th_bar = _adjoint_step(self.f, self.cfg, u_n, u_next,
                                        theta_p, self._time(n), self.dt, lam)
            return lam, tree_add(mu, th_bar)
        self._un.copy_(u_n)
        self._unext.copy_(u_next)
        self._set_times(n)
        self._run("adj_start")
        self._loop("adj_unit")
        self._run("adj_finish")
        return lam, mu

    # -- the masked units ------------------------------------------------------
    def _set_times(self, n: int) -> None:
        # on the host, outside any graph: t_n and t_n + h as the eager route
        # computes them
        self._t.fill_(self._time(n))
        self._tn.fill_(self._time(n) + self.dt)

    def _theta(self):
        return pytree.tree_unflatten(self._th, self.th_spec)

    def _jv(self):
        """(I - h theta J) w at the Newton iterate, on (B, n) blocks."""
        lay, th, tn = self._lay, self._theta(), self._tn
        scale = -self.dt * self.cfg.theta
        v = lay.unflat(self._v)

        def A(w):
            wt = lay.unflat(w)
            _, jw = torch.func.jvp(lambda uu: self.f(uu, th, tn), (v,), (wt,))
            return lay.flat(tree_axpy(scale, jw, wt))
        return A

    def _newton_exit(self, mask) -> None:
        """For the lanes in ``mask``, whose iterate just changed: the
        residual and its norm, then either the next GMRES solve or the end
        of the step (stats merged, u <- v)."""
        lay, cfg, h = self._lay, self.cfg, self.dt
        v, g = lay.unflat(self._v), lay.unflat(self._g)
        r = tree_sub(tree_axpy(-h * cfg.theta, self.f(v, self._theta(),
                                                      self._tn), v), g)
        self._rnorm.copy_(torch.where(mask, lay.norm(r), self._rnorm))
        go_on = (self._it < cfg.newton_iters) \
            & (self._rnorm.double() > cfg.newton_tol)
        self._nlive.copy_(torch.where(mask, go_on, self._nlive))
        self._gm.begin(self._jv(), -1.0 * lay.flat(r), mask & go_on,
                       tol=cfg.gmres_tol, atol=0.0)
        done = mask & ~go_on
        converged = self._rnorm.double() <= cfg.newton_tol
        self._diverged.copy_(self._diverged | (done & ~converged))
        self._maxres.copy_(torch.where(
            done, torch.maximum(self._maxres, self._rnorm), self._maxres))
        self._iters.add_(torch.where(done, self._it, 0))
        self._u.copy_(torch.where(done[:, None], self._v, self._u))

    def _fwd_start(self) -> None:
        """f(u_n), the constant part and the explicit-Euler predictor, then
        the first residual."""
        lay, h, theta = self._lay, self.dt, self.cfg.theta
        u = lay.unflat(self._u)
        f_n = self.f(u, self._theta(), self._t)
        self._g.copy_(lay.flat(tree_axpy(h * (1.0 - theta), f_n, u)))
        self._v.copy_(lay.flat(tree_axpy(h, f_n, u)))
        self._it.zero_()
        self._newton_exit(torch.ones_like(self._nlive))

    def _fwd_unit(self) -> None:
        """One GMRES cycle of the live lanes; a lane whose GMRES ends takes
        the Newton update and its exit residual."""
        gm, cycles = self._gm, self.cfg.gmres_iters
        gm.cycle(self._jv(), self._nlive & gm.live(cycles), self._restart)
        done = self._nlive & ~gm.live(cycles)
        self._v.copy_(torch.where(done[:, None], self._v + gm.x, self._v))
        self._it.add_(done.to(torch.int64))
        self._newton_exit(done)
        self._live.copy_(self._nlive.any())

    def _vjp_next(self):
        lay, tn = self._lay, self._tn
        _, vjp = torch.func.vjp(lambda uu, th: self.f(uu, th, tn),
                                lay.unflat(self._unext), self._theta())
        return vjp

    def _jtv(self):
        """(I - h theta J(u_{n+1}))^T w, on (B, n) blocks."""
        lay, vjp = self._lay, self._vjp_next()
        scale = -self.dt * self.cfg.theta

        def A(w):
            wt = lay.unflat(w)
            u_bar, _ = vjp(wt)
            return lay.flat(tree_axpy(scale, u_bar, wt))
        return A

    def _adj_start(self) -> None:
        self._agm.begin(self._jtv(), self._lam, torch.ones_like(self._nlive),
                        tol=self.cfg.gmres_tol, atol=0.0)

    def _adj_unit(self) -> None:
        agm, cycles = self._agm, self.cfg.gmres_iters
        agm.cycle(self._jtv(), agm.live(cycles), self._restart)
        self._live.copy_(agm.live(cycles).any())

    def _adj_finish(self) -> None:
        """lambda_n and the theta increment from the transposed solve."""
        lay, h, theta = self._lay, self.dt, self.cfg.theta
        lam_s = lay.unflat(self._agm.x)
        _, vjp_n = torch.func.vjp(lambda uu, th: self.f(uu, th, self._t),
                                  lay.unflat(self._un), self._theta())
        u_bar_n, th_bar_n = vjp_n(tree_scale(h * (1.0 - theta), lam_s))
        lam_prev = tree_add(lam_s, u_bar_n)
        _, th_bar_next = self._vjp_next()(tree_scale(h * theta, lam_s))
        th_bar = tree_add(th_bar_n, th_bar_next)
        self._lam.copy_(lay.flat(lam_prev))
        for buf, x in zip(self._mu, pytree.tree_leaves(th_bar)):
            buf.add_(x)

    # -- running the units -----------------------------------------------------
    def _unit(self, key: str):
        return {"start": self._fwd_start, "unit": self._fwd_unit,
                "adj_start": self._adj_start, "adj_unit": self._adj_unit,
                "adj_finish": self._adj_finish}[key]

    def _capture(self, keys) -> None:
        """Capture the units ``keys`` not captured yet.  A capture's warm-up
        runs the unit once on the buffers as they stand; callers load the
        buffers the solve reads after it."""
        for key in keys:
            if key in self._graphs:
                continue
            fn = self._unit(key)
            g = StepGraph(lambda held, copied, fn=fn: (fn(), self._live)[1],
                          clone_outputs=False)
            g.capture(self._held, ())
            self._graphs[key] = g

    def _run(self, key: str) -> None:
        if self.capture:
            self._graphs[key](self._held, ())
        else:
            self._unit(key)()

    def _loop(self, key: str) -> None:
        """Units until no lane is live: the host reads ``live`` after every
        ``CHECK_EVERY`` of them (units past a lane's end change nothing)."""
        while True:
            for _ in range(CHECK_EVERY):
                self._run(key)
            self.replays += CHECK_EVERY
            self.live_reads += 1
            if not bool(self._live):
                return

    def _read_stats(self) -> ImplicitStats:
        """The forward sweep's stats: per-lane tensors with lanes, else one
        host read."""
        if self.lanes:
            return ImplicitStats(self._diverged.clone(), self._maxres.clone(),
                                 self._iters.clone(),
                                 torch.zeros_like(self._iters))
        vals = torch.cat([x.to(torch.float64) for x in (
            self._diverged, self._maxres, self._iters)]).tolist()
        self.stats_reads += 1
        return ImplicitStats(bool(vals[0]), vals[1], int(vals[2]), 0)

    def graph_stats(self) -> dict:
        """{key: (warmup_ms, capture_ms, pool_bytes)} of the captured
        units; None on the CPU."""
        return {k: (g.warmup_ms, g.capture_ms, g.pool_bytes)
                for k, g in self._graphs.items()}


class _ImplicitFunction(torch.autograd.Function):
    """Custom gradient of one implicit checkpoint policy.  Inputs are the
    flattened leaves of u0 then theta_p; outputs the leaves of u_final."""

    @staticmethod
    def forward(ctx, solver: ImplicitSolver, box: list, *leaves):
        leaves = [x.detach() if torch.is_tensor(x) else x for x in leaves]
        out, stats, res = solver.forward_leaves(
            leaves[:solver.n_u], leaves[solver.n_u:], record=True)
        box.append(stats)
        ctx.solver, ctx.res = solver, res
        ctx.generation = solver.generation
        return tuple(out)

    @staticmethod
    def backward(ctx, *g_leaves):
        solver, res = ctx.solver, ctx.res
        ctx.res = None  # one reverse sweep consumes the checkpoints
        if res is None:
            raise RuntimeError("odeint_implicit's reverse sweep ran twice; "
                               "its checkpoints are consumed by the first")
        if ctx.generation != solver.generation:
            raise RuntimeError(
                "ImplicitSolver: the solver ran a later forward pass, which "
                "overwrote the buffers this reverse sweep reads; run each "
                "reverse sweep before the solver's next call, or keep one "
                "solver per call")
        grads = solver.backward_leaves(res, g_leaves)
        return (None, None, *(x.detach() for x in grads))
