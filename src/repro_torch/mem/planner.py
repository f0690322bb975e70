"""Byte-budget planner: solve for the Table-2 point instead of hand-picking.

Given a device-memory budget B, rank every reverse-accurate policy instance
by its extra reverse-pass f evaluations (the paper's NFE-B) and choose the
cheapest one whose peak bytes fit:

  naive(0 extra)  >  pnode  >  revolve(N_c as large as fits)  >  pnode2
  >  aca  >  [nothing fits on device]  pnode + spill offload

For revolve the planner picks the *largest* N_c whose checkpoint set
(N_c+1)(N_s+1)S fits — by Prop. 2 that minimizes recomputation, so a larger
budget can never cost more f evaluations.  The spill tier is a last
resort: it keeps NFE-B at pnode's optimum but pays host traffic the NFE
metric does not see, so it never outranks an in-device policy that fits.
When the plan offloads, ``ram_budget`` / ``disk_budget`` bound the
off-device media: the planner solves the ``snaps_in_ram`` split (slots
over the RAM cap sink to disk; ``offload="disk"`` when no slot fits RAM).
In measure mode the fallback is measured on its tier
(``measure_reverse_cost(offload=...)``), and ``odeint(adjoint="auto")``
runs the plan it returns (``repro_torch.mem.offload``).

Two verify modes:

  "model"    trust the analytic model (no gradient is run);
  "measure"  walk the candidate list measuring each candidate's gradient
             (``measure_reverse_cost``: the CUDA allocator's peak on the
             card, live tensor storage on the CPU) against the budget —
             the mode ``odeint(adjoint="auto", mem_budget=...)`` uses by
             default, so the policy it returns fits as measured.
             Measurements are cached per (f, shapes, config), so a
             training loop pays the walk once.

``plan_depth_remat`` applies the same budget logic to the depth dimension
(the LM layer stack's remat policy).

The walk and its report are the JAX package's (``repro/mem/planner.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.core.implicit import is_implicit_method
from repro_torch.mem.model import (CostEstimate, f_activation_bytes,
                                   max_fitting_ncheck, measure_reverse_cost,
                                   policy_cost, slot_bytes, tree_bytes)

PyTree = Any


@dataclass(frozen=True)
class CandidateDecision:
    """One row of the ``explain=True`` planner report: a candidate the
    budget walk considered, whether it won, and — for every non-chosen
    candidate — exactly why it was rejected or skipped."""
    policy: str
    ncheck: Optional[int]
    offload: Optional[str]
    predicted_peak_bytes: int
    extra_fevals: int
    chosen: bool
    reason: str
    measured_bytes: Optional[float] = None
    snaps_in_ram: Optional[int] = None
    snaps_on_disk: Optional[int] = None

    def to_json(self) -> dict:
        return {"policy": self.policy, "ncheck": self.ncheck,
                "offload": self.offload,
                "predicted_peak_bytes": self.predicted_peak_bytes,
                "extra_fevals": self.extra_fevals, "chosen": self.chosen,
                "reason": self.reason,
                "measured_bytes": self.measured_bytes,
                "snaps_in_ram": self.snaps_in_ram,
                "snaps_on_disk": self.snaps_on_disk}


@dataclass(frozen=True)
class Plan:
    policy: str
    ncheck: Optional[int]
    offload: Optional[str]
    predicted: CostEstimate
    budget: Optional[int]
    fits: bool                      # predicted/measured peak <= budget
    measured_bytes: Optional[float] = None   # set in verify="measure"
    candidates: Tuple[CostEstimate, ...] = field(default=())
    #: populated by ``plan_odeint(..., explain=True)``: one decision per
    #: in-device candidate (same order as ``candidates``), plus the spill
    #: fallback row when the walk fell through to it
    report: Tuple[CandidateDecision, ...] = field(default=())
    #: the solved RAM/disk slot split when the plan offloads under a
    #: ram_budget: snaps_in_ram slots stay host-RAM-resident, the
    #: remaining snaps_on_disk sink to segment files (None when the split
    #: does not apply — no offload, or everything fits in RAM)
    snaps_in_ram: Optional[int] = None
    snaps_on_disk: Optional[int] = None

    @property
    def extra_fevals(self) -> int:
        return self.predicted.extra_fevals


def _solver_kw(solver_opts: Optional[dict]) -> dict:
    """The slice of solver_opts the cost model depends on."""
    so = solver_opts or {}
    return dict(newton_iters=int(so.get("newton_iters", 10)),
                gmres_iters=int(so.get("gmres_iters", 20)))


def candidate_costs(*, method: str, n_steps: int, state_bytes: int,
                    theta_bytes: int = 0, f_act_bytes: Optional[int] = None,
                    mem_budget: Optional[int] = None,
                    solver_opts: Optional[dict] = None
                    ) -> List[CostEstimate]:
    """In-device candidates, cheapest recomputation first.  revolve appears
    once, at the largest N_c that fits the budget (or N_c=1 when nothing
    does, as the minimum-memory in-device fallback).

    Implicit methods get the implicit candidate set: pnode (converged
    states only — already the memory floor per step), then the revolve /
    revolve2 checkpoint-spacing points at the largest fitting N_c; the
    AD-through-the-step policies (naive/anode/aca/pnode2) do not exist for
    implicit solves (no reverse rule through Newton/GMRES while_loops)."""
    if is_implicit_method(method):
        kw = dict(method=method, n_steps=n_steps, state_bytes=state_bytes,
                  theta_bytes=theta_bytes, **_solver_kw(solver_opts))
        cands = [policy_cost("pnode", **kw)]
        if n_steps >= 2:
            k = None
            if mem_budget is not None:
                k = max_fitting_ncheck(mem_budget, method=method,
                                       n_steps=n_steps,
                                       state_bytes=state_bytes,
                                       theta_bytes=theta_bytes,
                                       **_solver_kw(solver_opts))
            cands.append(policy_cost("revolve", ncheck=k if k else 1, **kw))
            cands.append(policy_cost("revolve2", ncheck=k if k else 1, **kw))
        cands.sort(key=lambda c: (c.extra_fevals, c.peak_bytes))
        return cands
    kw = dict(method=method, n_steps=n_steps, state_bytes=state_bytes,
              theta_bytes=theta_bytes, f_act_bytes=f_act_bytes)
    cands = [policy_cost("naive", **kw), policy_cost("pnode", **kw)]
    if n_steps >= 2:
        k = None
        if mem_budget is not None:
            k = max_fitting_ncheck(mem_budget, method=method,
                                   n_steps=n_steps, state_bytes=state_bytes,
                                   theta_bytes=theta_bytes)
        cands.append(policy_cost("revolve", ncheck=k if k else 1, **kw))
    cands.append(policy_cost("pnode2", **kw))
    cands.append(policy_cost("aca", **kw))
    cands.sort(key=lambda c: (c.extra_fevals, c.peak_bytes))
    return cands


def _spill_split(method: str, n_steps: int, state_bytes: int,
                 ram_budget: Optional[int], disk_budget: Optional[int]
                 ) -> Tuple[str, Optional[int], Optional[int], bool, str]:
    """Solve the dolfin-adjoint RAM/disk slot split for a pnode spill
    fallback: how many of the n_steps checkpoint slots fit the RAM budget,
    the rest sink to disk.  Returns (offload, snaps_in_ram, snaps_on_disk,
    disk_fits, note) — offload='disk' is the snaps_in_ram=0 corner, a None
    split means everything stays in RAM."""
    if ram_budget is None:
        return "spill", None, None, True, "no ram_budget — all slots in RAM"
    sb = max(1, slot_bytes(method, state_bytes))
    k = int(ram_budget) // sb
    if k >= n_steps:
        return ("spill", None, None, True,
                f"ram_budget fits all {n_steps} slots "
                f"({sb} B/slot) — no disk split needed")
    on_disk = n_steps - k
    disk_fits = disk_budget is None or on_disk * sb <= int(disk_budget)
    note = (f"ram_budget fits {k}/{n_steps} slots ({sb} B/slot) — "
            f"{on_disk} slots sink to disk"
            + ("" if disk_fits else
               f"; disk_budget exceeded ({on_disk * sb} B needed)"))
    if k == 0:
        return "disk", None, on_disk, disk_fits, note
    return "spill", k, on_disk, disk_fits, note


def plan_odeint(f: Callable, u0: PyTree, theta: PyTree, *, dt: float,
                n_steps: int, t0: float = 0.0, method: str = "rk4",
                mem_budget: Optional[int] = None,
                ram_budget: Optional[int] = None,
                disk_budget: Optional[int] = None,
                verify: str = "measure",
                loss_fn: Optional[Callable] = None,
                solver_opts: Optional[dict] = None,
                batch: int = 1,
                explain: bool = False,
                fused_stages: bool = False) -> Plan:
    """Pick (policy, ncheck, offload) for one odeint call under a budget.

    ``explain=True`` additionally fills ``Plan.report`` with one
    ``CandidateDecision`` per candidate — same order as
    ``Plan.candidates`` — stating for the winner why it was chosen and
    for every other candidate why it was rejected (predicted or measured
    peak over budget) or skipped (a cheaper-recompute candidate already
    fit).  The walk itself is identical with or without ``explain``.

    ``loss_fn(u_final) -> scalar``: in ``verify="measure"`` mode the
    measured reverse pass is the gradient of THIS loss (the caller's
    training objective), so the budget check covers the loss's own working
    set too; when omitted the canonical sum-of-squares surrogate is
    measured (the pre-existing behavior).  Ignored in ``verify="model"``.

    ``solver_opts`` (newton_iters/newton_tol/gmres_iters/gmres_tol) applies
    to implicit methods: gmres_iters sets the Krylov-basis working-set
    term of the model and both iteration counts set the recompute price of
    a revolve segment; ``odeint_implicit(adjoint="auto")`` forwards its
    solver configuration here.  The same budget walk and spill fallback
    apply — the candidate set is just the implicit one (see
    ``candidate_costs``).

    ``ram_budget``/``disk_budget`` (bytes) bound the OFF-device media when
    the plan offloads: the planner solves the dolfin-adjoint
    ``snaps_in_ram`` split (``Plan.snaps_in_ram``/``snaps_on_disk``) so at
    most ram_budget bytes of checkpoint slots stay host-RAM-resident and
    the overflow sinks to disk segment files — ``offload="disk"`` when
    the RAM budget fits no slot at all.  With ``ram_budget`` alone (no
    ``mem_budget``) the plan is the long-trajectory shape directly: pnode
    + spill/disk offload under the RAM cap, no device-budget walk.  A
    disk_budget the overflow exceeds marks the plan ``fits=False`` (best
    effort), mirroring the device-budget semantics.

    ``batch`` prices a BATCHED solve (the serving engine's vmapped lane
    dimension): per-step state and f-activation working sets scale by the
    lane count — and so does every spill checkpoint slot, which is what
    sizes the batched offload working set — while ``theta`` is shared
    across lanes and does not.  ``batch > 1`` uses the analytic model for
    the budget walk (``verify="model"`` semantics) since the measured
    reverse pass runs the unbatched program.

    ``fused_stages`` (the port's own) measures the checkpointing policies
    through the fused stage kernel, as ``odeint(fused_stages=True)`` runs
    them; the other policies run unfused, as ``odeint`` runs them.
    """
    b = int(batch)
    if b < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if b > 1:
        verify = "model"
    state_bytes_ = tree_bytes(u0) * b
    if mem_budget is None and ram_budget is not None:
        # RAM-bounded offload without a device budget: the ROADMAP
        # long-trajectory shape — keep pnode's zero-recompute optimum,
        # move every checkpoint slot off device, split RAM/disk by budget
        off, in_ram, on_disk, disk_fits, note = _spill_split(
            method, n_steps, state_bytes_, ram_budget, disk_budget)
        est = policy_cost("pnode", method=method, n_steps=n_steps,
                          state_bytes=state_bytes_,
                          theta_bytes=tree_bytes(theta), offload=off,
                          snaps_in_ram=0 if off == "disk" else in_ram,
                          **_solver_kw(solver_opts))
        report = ()
        if explain:
            report = (CandidateDecision(
                "pnode", None, off, int(est.peak_bytes),
                int(est.extra_fevals), True,
                f"chosen: ram_budget without mem_budget — pnode + {off} "
                f"offload; {note}", None, in_ram, on_disk),)
        return Plan("pnode", None, off, est, None, disk_fits,
                    report=report, snaps_in_ram=in_ram,
                    snaps_on_disk=on_disk)
    if mem_budget is None:
        # no constraint: the paper's method — no recompute beyond the
        # per-stage linearizations, bounded graph depth
        est = policy_cost("pnode", method=method, n_steps=n_steps,
                          state_bytes=state_bytes_,
                          theta_bytes=tree_bytes(theta),
                          **_solver_kw(solver_opts))
        report = ()
        if explain:
            report = (CandidateDecision(
                "pnode", None, None, int(est.peak_bytes),
                int(est.extra_fevals), True,
                "chosen: no mem_budget — paper-default pnode (zero "
                "recompute beyond stage linearizations, bounded graph "
                "depth)"),)
        return Plan("pnode", None, None, est, None, True, report=report)
    if verify not in ("model", "measure"):
        raise ValueError(f"verify must be 'model' or 'measure', "
                         f"got {verify!r}")
    state_bytes = tree_bytes(u0) * b
    theta_bytes = tree_bytes(theta)
    fa = f_activation_bytes(f, u0, theta, t0) * b
    cands = candidate_costs(method=method, n_steps=n_steps,
                            state_bytes=state_bytes, theta_bytes=theta_bytes,
                            f_act_bytes=fa, mem_budget=mem_budget,
                            solver_opts=solver_opts)

    def _measure(cand) -> float:
        return measure_reverse_cost(
            f, u0, theta, dt=dt, n_steps=n_steps, t0=t0, method=method,
            policy=cand.policy, ncheck=cand.ncheck, loss_fn=loss_fn,
            solver_opts=solver_opts, fused_stages=fused_stages)["peak_bytes"]

    # per-candidate outcome bookkeeping for the explain report:
    # index -> (reason, measured_bytes or None)
    status: dict = {}
    chosen_idx: Optional[int] = None
    measured: Optional[float] = None
    for i, cand in enumerate(cands):
        if cand.peak_bytes > mem_budget:
            status[i] = (f"rejected: predicted peak {int(cand.peak_bytes)} B"
                         f" > budget {mem_budget} B", None)
            continue
        if verify == "measure":
            m = _measure(cand)
            if m > mem_budget:
                status[i] = (f"rejected: measured peak {int(m)} B > budget"
                             f" {mem_budget} B", m)
                continue
            measured = m
        chosen_idx = i
        status[i] = ("chosen: cheapest extra-NFE-B candidate whose peak "
                     "fits the budget", measured)
        break

    if chosen_idx is None and verify == "measure":
        # the model ruled candidates out; re-walk against measurement in
        # case the model over-estimated (it is deliberately conservative)
        for i, cand in enumerate(cands):
            m = _measure(cand)
            if m <= mem_budget:
                chosen_idx = i
                measured = m
                status[i] = ("chosen: model over-estimated (predicted "
                             f"{int(cand.peak_bytes)} B) but measured peak "
                             f"{int(m)} B fits the budget", m)
                break
            if cand.peak_bytes > mem_budget:
                status[i] = (f"rejected: predicted {int(cand.peak_bytes)} B"
                             f" and measured {int(m)} B both exceed budget"
                             f" {mem_budget} B", m)
            # else: keep the walk-1 measured-rejection reason

    def _report(spill_dec: Optional[CandidateDecision] = None):
        if not explain:
            return ()
        rows = []
        for i, cand in enumerate(cands):
            reason, m = status.get(
                i, ("skipped: a cheaper-recompute candidate already fit "
                    "(candidates are ranked by extra NFE-B, then peak "
                    "bytes)", None))
            rows.append(CandidateDecision(
                cand.policy, cand.ncheck, None, int(cand.peak_bytes),
                int(cand.extra_fevals), i == chosen_idx, reason, m))
        if spill_dec is not None:
            rows.append(spill_dec)
        return tuple(rows)

    if chosen_idx is not None:
        cand = cands[chosen_idx]
        return Plan(cand.policy, cand.ncheck, None, cand, mem_budget, True,
                    measured, tuple(cands), _report())

    # nothing fits on device: keep pnode's optimal NFE-B and move the
    # checkpoint storage off device through the spill store, split across
    # RAM and disk by the off-device budgets
    off, in_ram, on_disk, disk_fits, note = _spill_split(
        method, n_steps, state_bytes, ram_budget, disk_budget)
    est = policy_cost("pnode", method=method, n_steps=n_steps,
                      state_bytes=state_bytes, theta_bytes=theta_bytes,
                      f_act_bytes=fa, offload=off,
                      snaps_in_ram=0 if off == "disk" else in_ram,
                      **_solver_kw(solver_opts))
    measured = None
    fits = est.peak_bytes <= mem_budget
    if verify == "measure":
        measured = measure_reverse_cost(
            f, u0, theta, dt=dt, n_steps=n_steps, t0=t0, method=method,
            policy="pnode", offload=off, loss_fn=loss_fn,
            solver_opts=solver_opts, fused_stages=fused_stages)["peak_bytes"]
        fits = measured <= mem_budget
    fits = fits and disk_fits
    spill_dec = None
    if explain:
        spill_dec = CandidateDecision(
            "pnode", None, off, int(est.peak_bytes),
            int(est.extra_fevals), True,
            "chosen: fallback — no in-device candidate fits; spill keeps "
            "NFE-B at pnode's optimum and moves checkpoint storage off "
            f"device ({note})"
            + ("" if fits else
               " (best effort: the working set or the disk overflow "
               "exceeds its budget)"),
            measured, in_ram, on_disk)
    return Plan("pnode", None, off, est, mem_budget, fits, measured,
                tuple(cands), _report(spill_dec), snaps_in_ram=in_ram,
                snaps_on_disk=on_disk)


# ---------------------------------------------------------------------------
# depth-level planning (the LM layer stack)
# ---------------------------------------------------------------------------

def depth_remat_live_bytes(cfg, cell, remat: str, ncheck: Optional[int],
                           act_mult: float = 12.0) -> int:
    """The depth planner's predicted live bytes for a chosen
    (remat, ncheck) point — the number a training launcher compares
    with its measured peak (drift check)."""
    bytes_per = 2 if cfg.compute_dtype in ("bfloat16", "float16") else 4
    state = cell.global_batch * cell.seq_len * cfg.d_model * bytes_per
    act = int(act_mult * state)
    n = cfg.n_layers
    if remat == "none":
        return n * act
    if remat == "sqrt":
        seg = max(1, int(math.sqrt(n)))
        return (seg + math.ceil(n / seg)) * act
    if remat == "full":
        return n * state + act
    if remat == "revolve":
        k = ncheck or 1
        return k * state + math.ceil(n / (k + 1)) * act
    raise ValueError(f"unknown depth remat policy {remat!r}")


def plan_depth_remat(cfg, cell, mem_budget: int,
                     act_mult: float = 12.0
                     ) -> Tuple[str, Optional[int], bool]:
    """Map a byte budget to a depth-checkpointing policy for the layer-stack
    scan (``core/depth_ode.py::checkpointed_scan``, which
    ``nn/transformer.py::apply_stack`` runs): the ResNet<->ODE duality
    makes the layer stack a forward-Euler solve, so the same Table-2 trade
    applies with S = one residual-stream state and A ~ act_mult*S the
    transformer block's live activations.

    Candidates, cheapest recompute first:
      none     live ~ N_l * A            0 recomputed layers
      sqrt     live ~ 2*sqrt(N_l) * A    ~N_l recomputed layers (1x each)
      full     live ~ N_l*S + A          ~N_l recomputed layers, O(1) acts
      revolve  live ~ N_c*S + seg*A      Prop-2 recompute over layers

    Returns (remat, ncheck, fits); fits=False means even the minimum-live
    revolve point exceeds the budget (the caller should warn — the plan is
    best-effort, not a guarantee).
    """
    bytes_per = 2 if cfg.compute_dtype in ("bfloat16", "float16") else 4
    state = cell.global_batch * cell.seq_len * cfg.d_model * bytes_per
    act = int(act_mult * state)
    n = cfg.n_layers
    seg = max(1, int(math.sqrt(n)))
    options: List[Tuple[str, Optional[int], int]] = [
        ("none", None, n * act),
        ("sqrt", None, (seg + math.ceil(n / seg)) * act),
        ("full", None, n * state + act),
    ]
    for remat, ncheck, live in options:
        if live <= mem_budget:
            return remat, ncheck, True

    def rev_live(k: int) -> int:
        # boundary states + one in-flight segment's activations (the
        # checkpointed segment recomputed under AD in the reverse pass)
        return k * state + math.ceil(n / (k + 1)) * act

    fitting = [k for k in range(1, n) if rev_live(k) <= mem_budget]
    if fitting:
        # most slots that fit => shortest segments => least recompute depth
        return "revolve", max(fitting), True
    best = min(range(1, n), key=rev_live) if n > 1 else 1
    return "revolve", best, False
