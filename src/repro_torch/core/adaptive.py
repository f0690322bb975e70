"""Adaptive-step Dopri5 with a discrete adjoint over *accepted* steps
(paper §4: rejected steps cost the reverse pass nothing).

The forward pass is a loop of attempts with a PI step-size controller.  An
accepted attempt writes (state, stages, h, t) into a preallocated ring of
``max_steps`` slots, on the state's device; a rejected one writes nothing.
The reverse pass applies ``rk_adjoint_step`` to the accepted steps only,
newest first, each with its own h: the host knows ``n_accepted`` once the
forward has ended, so it runs exactly that many adjoint steps and NFE-B is
``adjoint_stages('dopri5') * n_accepted`` whatever ``max_steps`` is.

Every attempt runs on the device with no host read.  The loop's carry (u,
t, h, n_accepted, n_rejected, the previous error norm) lives in static
buffers, and an attempt is masked by the loop condition it computes
first: once the condition is false an attempt changes nothing.  So the
attempt can be captured as one CUDA graph (``capture=True``, through
``launch.graphs.StepGraph``, the port's counterpart of the JAX package's
``jax.jit`` around ``odeint_adaptive``) and replayed; the host reads the
0-d ``live`` flag after every ``CHECK_EVERY`` replays (each read is one
device-to-host synchronization; replays past the end change nothing).  The reverse sweep
is one captured adjoint step whose ring slot is a device tensor, replayed
``n_accepted`` times; it is captured at the end of the first recording
forward pass, so no capture runs inside autograd's backward.  Eager and captured runs execute the same functions
on the same buffers, so on one card they agree bitwise.

t, h and the error norms are 0-d tensors of the state's dtype, so h reaches
``fused_lincomb`` as a device scalar: ``fused_stages=True`` runs every
stage update and every adjoint stage recursion through the kernel's scaled
form.  A CPU state takes the kernel's plain version.

``offload="spill"`` or ``"disk"`` keeps the accepted steps in a
``repro_torch.mem.offload`` store instead: the device ring shrinks from
``max_steps`` slots to ``segment + CHECK_EVERY`` (``offload_segment``,
default ceil(sqrt(max_steps))), the slack for the attempts that run
between two host reads.  At each read of ``live`` that the host already
makes, it reads the accepted count in the same copy and ships every full
segment of the ring with one ``write_batch``, outside any captured graph;
the steps not yet shipped move to the front of the ring and a device
offset (``ring_base``) tells the attempt where the next one goes.  The
last, partial segment goes when the loop ends.  The reverse sweep
prefetches one segment at a time into the ring, newest first, and replays
the adjoint step over it.  Gradients are bitwise the device ring's.

``obs=`` (a ``repro_torch.obs.FlightRecorder``) keeps an attempt log on
the device: ``8 * max_steps`` rows (the attempt cap) of (t, h, error norm,
accept), row ``n_accepted + n_rejected`` written inside the attempt,
masked by ``live``, with no host read, so also inside the captured
attempt (which then has a graph of its own).  At the end of the forward
pass, where the host reads the counts anyway, the log's first ``n_accepted
+ n_rejected`` rows go to the recorder as ``adaptive.step`` events (read
at ``obs.sync()``), and the solve records ``adaptive.solve`` and
``adaptive.adjoint`` and binds the recorder to the ring's store.  With
``obs=None`` the attempt and its graph are unchanged.

``fault_plan=`` (a ``repro_torch.ft.FaultPlan``) poisons f's outputs with
NaN at the attempts its ``adaptive``/``nan`` specs cover, keyed by the
device attempt counter (``traced_gate``: a device bool, so it works in the
captured attempt).  The controller survives without help: a NaN error
norm rejects the attempt, the non-finite PI factor falls back to the
maximum shrink, and the attempt cap bounds a run of rejections.  With
``offload="spill"``/``"disk"`` the plan's downed tiers walk the
degradation ladder (``mem.offload.effective_tier``, ``scanned``), and the
plan arms the store's fault sites.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.adjoint import lincomb_launches_per_step
from repro_torch.core.integrators import (
    PyTree,
    VectorField,
    rk_adjoint_step,
    rk_combine,
    rk_stages,
    tree_add,
    tree_map,
)
from repro_torch.core.tableaus import DOPRI5
from repro_torch.launch.graphs import StepGraph
from repro_torch.obs.profile import scope

#: captured attempts replayed between two reads of the ``live`` flag
CHECK_EVERY = 4

#: the attempt log's columns (``obs=``), the reference's event fields
LOG_FIELDS = ("t", "h", "err_norm", "accept")

__all__ = ["AdaptiveInfo", "AdaptiveSolver", "odeint_adaptive",
           "expected_adaptive_lincomb_calls"]


class AdaptiveInfo(NamedTuple):
    n_accepted: int
    n_rejected: int
    nfe_forward: int


def _error_norm(u, u_new, err, rtol, atol):
    def leaf(e, a, b):
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        return torch.sum((e / scale) ** 2), e.numel()

    parts = [leaf(e, a, b) for e, a, b in zip(
        pytree.tree_leaves(err), pytree.tree_leaves(u),
        pytree.tree_leaves(u_new))]
    total = sum(p[0] for p in parts)
    count = sum(p[1] for p in parts)
    return torch.sqrt(total / count)


def expected_adaptive_lincomb_calls(n_accepted: int, n_rejected: int,
                                    n_leaves: int,
                                    backward: bool = True) -> int:
    """Fused lincomb launches (or plain calls on the CPU) of one eager fused
    ``odeint_adaptive``: a dopri5 step's worth per attempt, accepted or
    rejected (the error estimate and the controller launch none), plus an
    adjoint step's worth per accepted step when ``backward``.  One launch
    per leaf.  Replays of a captured solve launch from the graph, which the
    host counters do not see."""
    _, step, adj = lincomb_launches_per_step(DOPRI5.name)
    fwd = (n_accepted + n_rejected) * step
    return (fwd + (n_accepted * adj if backward else 0)) * n_leaves


@contextlib.contextmanager
def _slot_writes():
    """``index_copy_`` of one ring slot.  Under deterministic algorithms
    PyTorch routes it on the card through an indexed write that checks the
    index range on the host, which a graph capture refuses; one index has
    no duplicate whose order could vary, so the plain kernel is as
    deterministic.  The setting is restored on exit."""
    det = torch.are_deterministic_algorithms_enabled()
    if not det:
        yield
        return
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True, warn_only=warn)


def _validate(method, offload, offload_segment, snaps_in_ram, offload_dir,
              max_steps):
    if method != "dopri5":
        raise ValueError("adaptive integration currently supports dopri5")
    if offload not in (None, "device", "spill", "disk"):
        raise ValueError(
            f"unknown offload tier {offload!r} for the adaptive ring "
            "buffer; one of (None, 'device', 'spill', 'disk')")
    if offload_segment is not None and offload not in ("spill", "disk"):
        raise ValueError(
            "offload_segment only applies to the spill/disk tiers; got "
            f"offload={offload!r}")
    if snaps_in_ram is not None and offload != "spill":
        raise ValueError(
            "snaps_in_ram is the spill tier's RAM/disk split "
            f"(offload='spill'); got offload={offload!r}")
    if offload_dir is not None and offload not in ("spill", "disk"):
        raise ValueError(
            "offload_dir pins the disk tier's segment files "
            f"(offload='spill'/'disk'); got offload={offload!r}")
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")


class AdaptiveSolver:
    """Adaptive Dopri5 from ``t0`` to ``t1`` for one vector field, with its
    buffers (and, with ``capture=True``, its CUDA graphs) kept across
    calls.  ``solver(u0, theta)`` returns ``(u_final, AdaptiveInfo)`` and is
    differentiable w.r.t. the tensor leaves of ``u0`` and ``theta`` (the
    discrete adjoint over accepted steps).

    Every call copies ``u0`` and ``theta`` into the static buffers, so a
    later call may pass other tensors of the same structure, shapes,
    dtypes and device (another shape raises).  The ring and the theta
    buffers hold the last forward pass: the reverse sweep of a call that
    was followed by another call raises.  On CPU tensors
    ``capture=True`` runs the same functions eagerly (``StepGraph``'s CPU
    behaviour).  ``obs`` and ``fault_plan`` are the module docstring's.
    See ``odeint_adaptive`` for the other arguments."""

    def __init__(self, f: VectorField, *, t0: float, t1: float,
                 rtol: float = 1e-6, atol: float = 1e-6,
                 max_steps: int = 512, h0: float | None = None,
                 method: str = "dopri5", fused_stages: bool = False,
                 capture: bool = False, offload: str | None = None,
                 offload_segment: int | None = None,
                 snaps_in_ram: int | None = None,
                 offload_dir: str | None = None, obs=None,
                 fault_plan=None):
        _validate(method, offload, offload_segment, snaps_in_ram,
                  offload_dir, max_steps)
        self.obs, self.fault_plan = obs, fault_plan
        if offload in ("spill", "disk") and fault_plan is not None:
            # a downed tier walks spill -> disk -> device (the
            # slot-addressed host tier cannot take the segmented ring)
            from repro_torch.mem.offload import effective_tier
            offload = effective_tier(offload, fault_plan, scanned=True,
                                     obs=obs)
        #: the tier of the accepted steps: None keeps them in the device
        #: ring, "spill"/"disk" in a store a recording forward pass
        self.offload = offload if offload in ("spill", "disk") else None
        self.store_kw = dict(snaps_in_ram=snaps_in_ram, disk_dir=offload_dir)
        self.segment = None
        if self.offload is not None:
            from repro_torch.mem.offload import default_segment
            seg = (int(offload_segment) if offload_segment is not None
                   else default_segment(int(max_steps)))
            self.segment = max(1, min(seg, int(max_steps)))
        #: the store of the last recording forward pass (spill/disk)
        self.store = None
        self.f = f
        self.t0, self.t1 = float(t0), float(t1)
        self.rtol, self.atol = float(rtol), float(atol)
        self.max_steps = int(max_steps)
        self.h0 = (float(h0) if h0 is not None
                   else (self.t1 - self.t0) / 100.0)
        self.fused = bool(fused_stages)
        self.capture = bool(capture)
        self.tab = DOPRI5
        self._layout = None
        self._ring = None
        self._generation = 0
        self._graphs: dict = {}
        #: replays of the captured attempt in the last forward pass
        self.replays = 0
        #: the captured steps' keys: an observed or faulted attempt has a
        #: graph of its own
        self._tag = ("_obs" if obs is not None else "") + (
            "_fault" if fault_plan is not None
            and fault_plan.has("adaptive", "nan") else "")

    # -- buffers ---------------------------------------------------------------
    def _bind(self, u_leaves, th_leaves, u_spec, th_spec) -> None:
        layout = (u_spec, th_spec,
                  [(x.shape, x.dtype, x.device) for x in u_leaves],
                  [(x.shape, x.dtype, x.device) for x in th_leaves])
        if self._layout is not None:
            if layout != self._layout:
                raise ValueError(
                    "AdaptiveSolver: u0/theta differ in structure, shape, "
                    "dtype or device from the first call; build a new "
                    "solver for them")
            return
        if not all(torch.is_tensor(x) for x in u_leaves + th_leaves):
            raise TypeError("AdaptiveSolver: every leaf of u0 and theta must "
                            "be a tensor")
        devices = {x.device for x in u_leaves + th_leaves}
        if len(devices) != 1:
            raise ValueError("AdaptiveSolver: u0 and theta must lie on one "
                             f"device, got {sorted(map(str, devices))}")
        self._layout = layout
        self.device = devices.pop()
        self.dtype = functools.reduce(torch.promote_types,
                                      [x.dtype for x in u_leaves])
        self._u_spec, self._th_spec = u_spec, th_spec
        scalar = dict(dtype=self.dtype, device=self.device)
        count = dict(dtype=torch.int64, device=self.device)
        self._u = [torch.zeros_like(x) for x in u_leaves]
        self._th = [torch.zeros_like(x) for x in th_leaves]
        self._t = torch.zeros((), **scalar)
        self._h = torch.zeros((), **scalar)
        self._err_prev = torch.zeros((), **scalar)
        self._n_acc = torch.zeros((), **count)
        self._n_rej = torch.zeros((), **count)
        self._live = torch.zeros((), dtype=torch.bool, device=self.device)
        self._lam = [torch.zeros_like(x) for x in u_leaves]
        self._mu = [torch.zeros_like(x) for x in th_leaves]
        self._slot = torch.zeros((1,), **count)
        #: accepted steps shipped to the store (spill/disk): ring slot of
        #: accepted step n is n - ring_base
        self._ring_base = torch.zeros((), **count)
        #: the attempt log (``obs``): row a is attempt a's LOG_FIELDS
        self._log = (torch.zeros((8 * self.max_steps, len(LOG_FIELDS)),
                                 **scalar) if self.obs is not None else None)

    @property
    def ring_slots(self) -> int:
        """Slots of the device ring: ``max_steps``, or ``segment +
        CHECK_EVERY`` (at most ``max_steps``) on the spill/disk tiers."""
        if self.offload is None:
            return self.max_steps
        return min(self.max_steps, self.segment + CHECK_EVERY)

    def _alloc_ring(self) -> None:
        if self._ring is not None:
            return
        m, s = self.ring_slots, self.tab.num_stages
        self._ring = dict(
            states=[x.new_zeros((m,) + x.shape) for x in self._u],
            stages=[x.new_zeros((m, s) + x.shape) for x in self._u],
            h=torch.zeros((m,), dtype=self.dtype, device=self.device),
            t=torch.zeros((m,), dtype=self.dtype, device=self.device))

    @property
    def ring_bytes(self) -> int:
        """Device bytes of the ring (0 until a recording pass made it)."""
        if self._ring is None:
            return 0
        return sum(x.numel() * x.element_size()
                   for x in pytree.tree_leaves(self._ring))

    def _held(self, key: str):
        """The buffers a captured step reads and writes, by address (the
        forward-only attempt runs without a ring)."""
        held = (self._u, self._th, self._t, self._h, self._err_prev,
                self._n_acc, self._n_rej, self._live, self._lam, self._mu,
                self._slot)
        if self.offload is not None:
            held += (self._ring_base,)
        if self._log is not None:
            held += (self._log,)
        return held if key == "attempt" + self._tag else held + (self._ring,)

    def _theta(self):
        return pytree.tree_unflatten(self._th, self._th_spec)

    # -- the forward loop --------------------------------------------------------
    def _live_now(self) -> torch.Tensor:
        # the loop condition; the attempt cap bounds a run of rejections
        # (the reference's 8 * max_steps)
        return ((self._t < self.t1 - 1e-14)
                & (self._n_acc < self.max_steps)
                & (self._n_acc + self._n_rej < 8 * self.max_steps))

    def _attempt(self, record: bool) -> None:
        """One attempt, masked by the loop condition: no host read, every
        result written in place into the carry (and, when ``record`` and
        accepted, into ring slot ``n_accepted``)."""
        tab, s, order = self.tab, self.tab.num_stages, self.tab.order
        live = self._live_now()
        u = pytree.tree_unflatten(self._u, self._u_spec)
        theta = self._theta()
        t = self._t
        h = torch.minimum(self._h, self.t1 - t)
        f = self.f
        bad = (self.fault_plan.traced_gate("adaptive", "nan",
                                           self._n_acc + self._n_rej)
               if self.fault_plan is not None else False)
        if bad is not False:
            def f(uu, th, tt, f0=self.f):
                return tree_map(lambda x: torch.where(
                    bad, torch.full_like(x, float("nan")), x), f0(uu, th, tt))
        ks = rk_stages(f, tab, u, theta, t, h, fused=self.fused)
        u_new = rk_combine(tab, u, ks, h, fused=self.fused)
        # embedded error estimate
        err = None
        for i in range(s):
            ci = float(tab.b[i] - tab.b_err[i])
            if ci == 0.0:
                continue
            term = tree_map(lambda k: h * ci * k, ks[i])
            err = term if err is None else tree_add(err, term)
        enorm = _error_norm(u, u_new, err, self.rtol, self.atol)
        accept = enorm <= 1.0

        # PI controller (Hairer-Norsett-Wanner II.4): alpha=0.7/p, beta=0.4/p
        alpha, beta = 0.7 / order, 0.4 / order
        factor = 0.9 * (enorm + 1e-10) ** (-alpha) \
            * (self._err_prev + 1e-10) ** beta
        # a NaN/Inf error norm falls back to the maximum shrink
        factor = torch.where(torch.isfinite(factor), factor, 0.2)
        factor = torch.clamp(factor, 0.2, 5.0)
        h_next = h * torch.where(accept, factor, torch.clamp(factor, max=1.0))

        take = accept & live
        if self._log is not None:
            # row n_accepted + n_rejected, written by live attempts only
            idx = torch.clamp(self._n_acc + self._n_rej,
                              max=self._log.shape[0] - 1).reshape(1)
            row = torch.stack([t, h, enorm.to(self.dtype),
                               accept.to(self.dtype)]).unsqueeze(0)
            with _slot_writes():
                self._log.index_copy_(0, idx, torch.where(
                    live, row, self._log.index_select(0, idx)))
        if record:
            pos = self._n_acc if self.offload is None \
                else self._n_acc - self._ring_base
            idx = torch.clamp(pos, max=self.ring_slots - 1).reshape(1)
            ring = self._ring
            rows = [(b, x) for b, x in zip(ring["states"], self._u)]
            rows += [(b, torch.stack([pytree.tree_leaves(k)[j] for k in ks]))
                     for j, b in enumerate(ring["stages"])]
            rows += [(ring["h"], h), (ring["t"], t)]
            with _slot_writes():
                for buf, x in rows:
                    old = buf.index_select(0, idx)
                    buf.index_copy_(0, idx, torch.where(take, x.unsqueeze(0),
                                                        old))
        for buf, new in zip(self._u, pytree.tree_leaves(u_new)):
            buf.copy_(torch.where(take, new, buf))
        self._t.copy_(torch.where(take, t + h, t))
        self._h.copy_(torch.where(live, h_next, self._h))
        self._err_prev.copy_(torch.where(take, enorm, self._err_prev))
        self._n_acc.add_(take.to(torch.int64))
        self._n_rej.add_((live & ~accept).to(torch.int64))
        self._live.copy_(self._live_now())

    def _reset(self, u_leaves, th_leaves) -> None:
        for buf, x in zip(self._u + self._th, list(u_leaves) + list(th_leaves)):
            buf.copy_(x)
        self._t.fill_(self.t0)
        self._h.fill_(self.h0)
        self._err_prev.fill_(1.0)
        self._n_acc.zero_()
        self._n_rej.zero_()
        self._live.copy_(self._live_now())

    def _graph(self, key, fn):
        """The captured step ``key``, captured on first use.  Its warm-up
        runs ``fn`` once: callers put the buffers in a state where that run
        changes nothing they read afterwards."""
        g = self._graphs.get(key)
        if g is None:
            g = StepGraph(lambda held, copied: (fn(), self._live)[1],
                          clone_outputs=False)
            g.capture(self._held(key), ())
            self._graphs[key] = g
        return g

    def graph_stats(self) -> dict:
        """{key: (warmup_ms, capture_ms, pool_bytes)} of the captured
        steps ("attempt" / "attempt_record" / "adjoint"); None on the CPU."""
        return {k: (g.warmup_ms, g.capture_ms, g.pool_bytes)
                for k, g in self._graphs.items()}

    @scope("adaptive/fwd")
    def _forward(self, u_leaves, th_leaves, record: bool):
        # a later call overwrites the theta buffers (and, recording, the
        # ring) that an earlier call's reverse sweep would read
        self._generation += 1
        if record:
            self._alloc_ring()
        if self.obs is not None:
            self.obs.record("adaptive.solve", method=self.tab.name,
                            t0=self.t0, t1=self.t1, rtol=self.rtol,
                            atol=self.atol, max_steps=self.max_steps,
                            h0=self.h0, offload=self.offload,
                            segment=self.segment or 1, fused=self.fused)
        graph = None
        if self.capture:
            key = ("attempt_record" if record else "attempt") + self._tag
            if key not in self._graphs:
                self._t.fill_(self.t1)   # a dead carry: the warm-up is a no-op
                self._live.zero_()
            graph = self._graph(key, lambda: self._attempt(record))
        self._reset(u_leaves, th_leaves)
        self.replays = 0
        reps = 1 if graph is None else CHECK_EVERY
        if record and self.offload is not None:
            self._spill_loop(graph, reps)
        elif graph is None:
            while bool(self._live):
                self._attempt(record)
        else:
            held = self._held(key)
            while bool(self._live):
                for _ in range(CHECK_EVERY):
                    graph(held, ())
                self.replays += CHECK_EVERY
        n_acc, n_rej = int(self._n_acc), int(self._n_rej)
        if self.obs is not None:
            self.obs.emit_rows("adaptive.step",
                               self._log[:n_acc + n_rej].clone(), LOG_FIELDS,
                               index="attempt", casts={"accept": bool})
        if record and self.capture and n_acc > 0 \
                and "adjoint" not in self._graphs:
            # capture the adjoint step here, on the caller's thread, not
            # inside autograd's backward; its warm-up step reads slot 0 and
            # writes lam and mu, which the reverse sweep resets
            self._slot.zero_()
            self._graph("adjoint", self._adjoint_step)
        return AdaptiveInfo(n_acc, n_rej, (n_acc + n_rej) * self.tab.num_stages)

    def _spill_loop(self, graph, reps: int) -> None:
        """The recording loop on the spill/disk tiers: ``reps`` attempts (a
        replay each when captured) between host reads, and at each read
        the full segments of the ring shipped to a new store."""
        from repro_torch.mem.offload import make_store
        self.store = make_store(self.offload, fault_plan=self.fault_plan,
                                **self.store_kw)
        if self.obs is not None:
            self.store.bind_obs(self.obs)
        self._ring_base.zero_()
        shipped = 0
        held = None if graph is None else self._held(
            "attempt_record" + self._tag)
        while True:
            # live and the accepted count in one device-to-host copy
            live, n_acc = torch.stack(
                (self._live.to(torch.int64), self._n_acc)).tolist()
            shipped = self._ship(n_acc, shipped, final=not live)
            if not live:
                return
            for _ in range(reps):
                if graph is None:
                    self._attempt(True)
                else:
                    graph(held, ())
            if graph is not None:
                self.replays += reps

    def _ring_rows(self, m: int):
        ring = self._ring
        return (ring["states"] + ring["stages"] + [ring["h"], ring["t"]],
                [b[:m] for b in ring["states"] + ring["stages"]]
                + [ring["h"][:m], ring["t"][:m]])

    def _ship(self, n_acc: int, shipped: int, final: bool) -> int:
        """Ship every full segment of the ring (and, when ``final``, the
        partial rest) to the store: one ``write_batch`` a segment from ring
        slots [0, segment), then the steps not shipped move to the front
        once the copy has read them.  Returns the steps shipped."""
        from repro_torch.mem.offload import wait_copy
        seg = self.segment
        while n_acc - shipped >= seg:
            bufs, rows = self._ring_rows(seg)
            wait_copy(self.store.write_batch(shipped, rows))
            rest = n_acc - shipped - seg
            for b in bufs:
                if rest:
                    src = b[seg:seg + rest]
                    b[:rest].copy_(src if rest <= seg else src.clone())
            shipped += seg
            self._ring_base.fill_(shipped)
        if final and n_acc > shipped:
            _, rows = self._ring_rows(n_acc - shipped)
            wait_copy(self.store.write_batch(shipped, rows))
            shipped = n_acc
        return shipped

    # -- the reverse sweep -------------------------------------------------------
    def _adjoint_step(self) -> None:
        """The adjoint of the accepted step in ring slot ``self._slot`` (a
        device index): lam and mu updated in place, the slot decremented."""
        ring, slot = self._ring, self._slot
        u_n = pytree.tree_unflatten(
            [b.index_select(0, slot)[0] for b in ring["states"]],
            self._u_spec)
        k_n = pytree.tree_unflatten(
            [b.index_select(0, slot)[0] for b in ring["stages"]],
            self._u_spec)
        h_n = ring["h"].index_select(0, slot)[0]
        t_n = ring["t"].index_select(0, slot)[0]
        lam = pytree.tree_unflatten(self._lam, self._u_spec)
        lam2, th_bar = rk_adjoint_step(self.f, self.tab, u_n, k_n,
                                       self._theta(), t_n, h_n, lam,
                                       fused=self.fused)
        for buf, x in zip(self._lam, pytree.tree_leaves(lam2)):
            buf.copy_(x)
        for buf, x in zip(self._mu, pytree.tree_leaves(th_bar)):
            buf.add_(x)
        slot.sub_(1)

    @scope("adaptive/bwd")
    def _reverse(self, g_leaves, n_acc: int, store=None):
        if self.obs is not None:
            self.obs.record("adaptive.adjoint", max_steps=self.max_steps,
                            segment=self.segment or 1,
                            tier=store.tier if store is not None
                            else "device")
        graph = self._graphs.get("adjoint") if self.capture else None
        for buf, x in zip(self._lam, g_leaves):
            buf.copy_(x)
        for buf in self._mu:
            buf.zero_()
        held = self._held("adjoint")

        def sweep(n):
            for _ in range(n):
                if graph is None:
                    self._adjoint_step()
                else:
                    graph(held, ())

        if store is None:
            self._slot.fill_(n_acc - 1)
            sweep(n_acc)
        else:
            # one segment at a time into the ring, newest first; the read
            # of the next is issued once this one is in hand
            seg = self.segment
            for base in reversed(range(0, n_acc, seg)):
                m = min(seg, n_acc - base)
                store.prefetch(base, m, out=self._ring_rows(m)[1])
                if base - seg >= 0:
                    store.prefetch_issue(base - seg, seg)
                self._slot.fill_(m - 1)
                sweep(m)
        return ([x.clone() for x in self._lam], [x.clone() for x in self._mu])

    # -- call ------------------------------------------------------------------
    def __call__(self, u0: PyTree, theta: PyTree):
        u_leaves, u_spec = pytree.tree_flatten(u0)
        th_leaves, th_spec = pytree.tree_flatten(theta)
        self._bind(u_leaves, th_leaves, u_spec, th_spec)
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in u_leaves + th_leaves):
            info_box: list = []
            out = _AdaptiveFunction.apply(self, info_box, *u_leaves,
                                          *th_leaves)
            info = info_box[0]
        else:
            with torch.no_grad():
                info = self._forward(u_leaves, th_leaves, record=False)
                out = [x.clone() for x in self._u]
        return pytree.tree_unflatten(list(out), u_spec), info


class _AdaptiveFunction(torch.autograd.Function):
    """The discrete adjoint over accepted steps.  Inputs are the flattened
    leaves of u0 then theta; outputs the leaves of u_final."""

    @staticmethod
    def forward(ctx, solver: AdaptiveSolver, info_box: list, *leaves):
        n_u = len(solver._u)
        info = solver._forward([x.detach() for x in leaves[:n_u]],
                               [x.detach() for x in leaves[n_u:]],
                               record=True)
        info_box.append(info)
        ctx.solver, ctx.n_acc = solver, info.n_accepted
        ctx.store = solver.store if solver.offload is not None else None
        ctx.generation = solver._generation
        return tuple(x.clone() for x in solver._u)

    @staticmethod
    def backward(ctx, *g_leaves):
        solver = ctx.solver
        if ctx.generation != solver._generation:
            raise RuntimeError(
                "odeint_adaptive: the solver ran a later forward pass; run "
                "each reverse sweep before the solver's next call")
        ctx.generation = None     # one reverse sweep per forward pass
        store, ctx.store = ctx.store, None
        lam, mu = solver._reverse(g_leaves, ctx.n_acc, store)
        return (None, None, *lam, *mu)


def odeint_adaptive(f: VectorField, u0: PyTree, theta: PyTree, *,
                    t0: float, t1: float, rtol: float = 1e-6,
                    atol: float = 1e-6, max_steps: int = 512,
                    h0: float | None = None, method: str = "dopri5",
                    offload: str | None = None,
                    offload_segment: int | None = None,
                    snaps_in_ram: int | None = None,
                    offload_dir: str | None = None,
                    fused_stages: bool = False,
                    obs=None, fault_plan=None):
    """Adaptive solve from t0 to t1, differentiable through the discrete
    adjoint over accepted steps.  Returns ``(u_final, AdaptiveInfo)`` with
    host integers.  ``h0`` defaults to (t1 - t0) / 100.  ``fused_stages``
    runs the stage updates and the adjoint stage recursion through
    ``fused_lincomb`` (its scaled form: h is a device scalar).  One eager
    solve; a caller that solves again and again with the same shapes keeps
    an ``AdaptiveSolver`` (``capture=True`` replays CUDA graphs).
    ``offload="spill"``/``"disk"`` keeps the accepted steps in a store,
    ``offload_segment`` a transfer (module docstring); ``snaps_in_ram``
    and ``offload_dir`` are ``odeint``'s; ``obs`` and ``fault_plan`` the
    module docstring's."""
    solver = AdaptiveSolver(f, t0=t0, t1=t1, rtol=rtol, atol=atol,
                            max_steps=max_steps, h0=h0, method=method,
                            fused_stages=fused_stages, offload=offload,
                            offload_segment=offload_segment,
                            snaps_in_ram=snaps_in_ram,
                            offload_dir=offload_dir, obs=obs,
                            fault_plan=fault_plan)
    return solver(u0, theta)
