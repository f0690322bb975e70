"""Deterministic fault injection: the chaos harness behind the recovery
stack (spill-store integrity + recompute fallback, Newton divergence
rescue, the train-loop sentinel, and checkpoint crash simulation).  The
port of the JAX package's ``repro/ft/inject.py``: the plan, its host-side
counters and its numpy corruption are copies (the same seed and salt give
the same bytes); ``traced_gate`` takes a host int or a device tensor.

Design constraints, in order:

* **Deterministic.**  No wall clock, no RNG draws at decision time.  Every
  fault is keyed by a *call index* at a named *site* (the Nth spill
  transfer, the Mth Newton step), so the same ``FaultPlan`` replayed
  against the same program fires the same faults in the same places.
  "Corrupt" payload bytes come from ``np.random.default_rng`` seeded by
  ``(plan.seed, site-salt)``: random-looking, reproducible.

* **Usable inside a captured graph.**  Host-side sites (spill transfers,
  checkpoint writes, the serve queue and decode loop) consume faults with
  ``tick(site)``, a lock-protected Python counter that advances once a
  call, on the thread that issues the call.  Solver-interior sites are
  keyed by the step index instead, via ``traced_gate(site, kind, idx)``:
  a host bool when the host knows the index (the eager implicit route), a
  device bool tensor when the index lives on the device (the adaptive
  attempt counter, inside a captured attempt).  Such faults re-fire
  deterministically when the adjoint recomputes a step, which the bitwise
  recovery contract needs: a recomputed segment replays its faults AND
  its rescues, reproducing the forward's bits.

* **Zero-cost when absent.**  ``traced_gate`` returns the Python constant
  ``False`` when the plan has no matching specs (callers then stage no
  gate), and every recovery path treats ``fault_plan=None`` as "do
  nothing".

Sites consumed in the port (see the modules for semantics):

  ``spill.write``   host, once a device-to-host transfer in issue order,
                    applied where the transfer lands; kinds ``drop``
                    (payload never stored) / ``corrupt`` (stored bytes
                    flipped *after* checksumming: corruption at rest).
  ``spill.read``    host, once a read *attempt* (retries re-tick); kind
                    ``flake`` (attempt fails; the store retries with
                    backoff, so ``count`` spans transient vs persistent).
  ``ckpt.write``    host, once a ``save_checkpoint`` commit, fired after
                    the data is staged but before the DONE marker; kinds
                    ``preempt`` (raise ``SimulatedPreemption``: SIGKILL
                    mid-write, tmp dir left behind) / ``error`` (raise
                    OSError: a full disk).
  ``newton``        step index, absolute; kinds ``nan`` / ``inf`` (poison
                    the exit state of that step's first solve attempt:
                    the result, not the vector field) / ``diverge``
                    (force the convergence flag false on the first
                    attempt).
  ``adaptive``      device attempt counter (accepted + rejected); kind
                    ``nan`` poisons that attempt's f.
  ``tier.<name>``   consulted by ``mem.offload.effective_tier``; kind
                    ``down`` marks the tier unavailable so the store
                    factory walks the degradation ladder.
  ``serve.request`` host, once a queue admission; kinds ``malformed`` /
                    ``oversize`` (the same ``AdmissionError`` rejection a
                    bad request takes; the request never occupies a lane).
  ``serve.decode``  host, once an ``LMEngine`` decode step; kind ``nan``
                    poisons exactly ONE lane's logits, resolving that
                    request's ticket with an error while its batch-mates
                    stay bitwise-correct.

The JAX package's ``train.step`` site (the train loop's sentinel and
preemption) has no consumer in the port yet.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class SimulatedPreemption(BaseException):
    """Injected mid-operation kill.  Deliberately a ``BaseException``:
    ``except Exception`` cleanup handlers do NOT see it, which is the
    point — a real SIGKILL runs no handlers, so simulated preemption must
    skip the tidy-up paths too (e.g. ``save_checkpoint`` leaves its
    uncommitted ``.tmp_step_*`` directory behind, and recovery must cope)."""


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire at ``site`` for call indices
    ``[index, index + count)`` (or, for traced sites, at traced step/attempt
    values in that window), with failure mode ``kind``."""
    site: str
    index: int
    kind: str
    count: int = 1

    def covers(self, i: int) -> bool:
        return self.index <= i < self.index + self.count


class FaultPlan:
    """A deterministic schedule of injected faults.

    Thread-safe: ``tick`` may be called from checkpoint commit threads
    concurrently with the caller's.  One plan
    instance should drive one experiment; ``reset()`` rewinds the call
    counters (e.g. between a warmup and the measured run).
    """

    def __init__(self, faults: Sequence[FaultSpec] = (), seed: int = 0):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._fired: List[Tuple[str, int, FaultSpec]] = []
        self._notes: List[Tuple[str, Any]] = []
        by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.faults:
            by_site.setdefault(s.site, []).append(s)
        self._by_site = by_site

    # -- host-side consumption ---------------------------------------------
    def tick(self, site: str) -> Optional[FaultSpec]:
        """Advance ``site``'s call counter; return the spec covering this
        call index (None = no fault here).  Each call to an instrumented
        operation — including a *retry* — ticks once, so a spec's
        ``count`` window distinguishes transient faults (retry escapes the
        window) from persistent ones (every retry still covered)."""
        with self._lock:
            i = self._calls.get(site, 0)
            self._calls[site] = i + 1
            for spec in self._by_site.get(site, ()):
                if spec.covers(i):
                    self._fired.append((site, i, spec))
                    return spec
        return None

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    # -- traced consumption -------------------------------------------------
    def traced_gate(self, site: str, kind: str, idx):
        """Does a (site, kind) spec cover index ``idx``?  Returns the Python
        constant ``False`` when no spec matches, so dormant callers stage
        nothing.  With an int ``idx`` (a step index the host knows) the
        answer is a Python bool.  With a tensor ``idx`` (an attempt counter
        on the device) it is a bool tensor of ``idx``'s shape on its device,
        built from comparisons against the static index windows: no host
        read, so it is safe inside a captured CUDA graph, and it fires again
        identically when a reverse sweep recomputes a step."""
        windows = [(s.index, s.index + s.count)
                   for s in self._by_site.get(site, ()) if s.kind == kind]
        if not windows:
            return False
        import torch
        if not torch.is_tensor(idx):
            i = int(idx)
            return any(lo <= i < hi for lo, hi in windows)
        hit = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
        for lo, hi in windows:
            hit = hit | ((idx >= lo) & (idx < hi))
        return hit

    def has(self, site: str, kind: str | None = None) -> bool:
        specs = self._by_site.get(site, ())
        return any(kind is None or s.kind == kind for s in specs)

    # -- static tier consultation -------------------------------------------
    def tier_disabled(self, tier: str) -> bool:
        """True if the plan marks storage tier ``tier`` unavailable
        (``FaultSpec(f"tier.{tier}", 0, "down")``).  Consulted by
        ``mem.offload.effective_tier`` when walking the degradation
        ladder; consultations are recorded as notes, not ticks."""
        down = self.has(f"tier.{tier}", "down")
        if down:
            self.note("tier.disabled", tier)
        return down

    # -- bookkeeping ---------------------------------------------------------
    def note(self, kind: str, data: Any) -> None:
        with self._lock:
            self._notes.append((kind, data))

    def fired(self, site: str | None = None) -> List[Tuple[str, int, FaultSpec]]:
        with self._lock:
            return [f for f in self._fired if site is None or f[0] == site]

    def fired_count(self, site: str | None = None,
                    kind: str | None = None) -> int:
        return sum(1 for s, _, spec in self.fired(site)
                   if kind is None or spec.kind == kind)

    def notes(self, kind: str | None = None) -> List[Tuple[str, Any]]:
        with self._lock:
            return [n for n in self._notes if kind is None or n[0] == kind]

    def reset(self) -> None:
        """Rewind call counters and the fired/notes logs (the plan's specs
        are immutable) — e.g. between a compile/warmup run and the
        measured run."""
        with self._lock:
            self._calls.clear()
            self._fired.clear()
            self._notes.clear()

    # -- deterministic corruption -------------------------------------------
    def corrupt_arrays(self, arrs: Sequence[np.ndarray],
                       salt: int) -> List[np.ndarray]:
        """Return corrupted copies of ``arrs``: every byte XOR'd with a
        stream from a ``(seed, salt)``-keyed generator — random-looking,
        bit-level, and exactly reproducible.  All-zero payloads corrupt
        too (XOR with a nonzero stream), so a checksum over the clean
        bytes always detects it."""
        rng = np.random.default_rng((self.seed, int(salt) & 0x7FFFFFFF))
        out = []
        for a in arrs:
            a = np.asarray(a)
            raw = a.tobytes()
            noise = rng.integers(1, 256, size=max(len(raw), 1),
                                 dtype=np.uint8)
            bad = (np.frombuffer(raw, np.uint8) ^ noise[:len(raw)]) \
                if raw else np.frombuffer(raw, np.uint8)
            out.append(np.frombuffer(bad.tobytes(), a.dtype)
                       .reshape(a.shape).copy())
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"FaultPlan(seed={self.seed}, faults={list(self.faults)}, "
                f"fired={len(self._fired)})")
