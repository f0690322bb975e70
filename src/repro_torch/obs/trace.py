"""Solver flight recorder: a structured, append-only trace of what a solve
actually did (per-attempt adaptive step decisions, per-step Newton health,
checkpoint-store traffic with segment ids and payload bytes), attached to a
solve with the ``obs=`` knob (``odeint`` / ``odeint_implicit`` /
``odeint_adaptive``, a checkpoint store's ``bind_obs``) and free when off:
with ``obs=None`` no solver records, copies or reads anything for it.  The
port of the JAX package's ``repro/obs/trace.py``: the same event kinds,
fields, ``seq``, ``ts`` and ``runtime`` flag, and the same helpers.

Two event classes, labelled by when they are recorded:

  schedule     configuration and schedule events (``odeint.solve``, the
               device and host tiers' ``store.put``/``get``/``free``, a
               tier's ``store.degrade``), ``runtime=False``.  Recorded by
               the host as it issues the work: once a call on the eager
               route, and once at capture for work inside a captured graph
               (the JAX package records them once a compilation).
  runtime      events carrying values the run computed (``adaptive.step``
               with h, the error norm and the verdict, ``implicit.steps``
               with the Newton exits, ``spill.write``/``spill.read`` with
               payload bytes), ``runtime=True``.

Runtime values from the device.  The JAX package gets them out of a
compiled program with ``jax.debug.callback`` and waits for them in
``sync()`` (``effects_barrier``).  Here a solver that computes them on the
device writes them into a device log of its own, inside the step (so also
inside a captured graph) and without a host read; it hands the log to the
recorder (``emit_rows``) at a host read it makes anyway, e.g.
the end of the adaptive forward pass.  The values stay on the device
until ``sync()``, which turns every pending log into events with one host
read each; ``events()`` calls it, as the JAX package's does.  Values the
host already holds (the eager implicit route reads every Newton exit) are
recorded at once.

Each emitter carries enough state to order its events (the adaptive rows
carry the attempt counter, spill events their slot base); the helpers
``adaptive_steps`` and ``spill_traffic`` sort on those fields.

Numerics: recording only reads values the solve computed, so gradients
with a recorder are bitwise those without.  Host-side mutation is
lock-guarded; events carry a monotonically increasing ``seq`` (an emitted
log takes its ``seq`` numbers when it is handed over).
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class TraceEvent:
    kind: str
    data: Dict[str, Any]
    seq: int
    runtime: bool  # True: a value the run computed; False: the schedule
    #: host wall clock at record (or hand-over) time, ``time.time()``; the
    #: Perfetto export (``obs.trace_export``) uses it for the timeline
    ts: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "seq": self.seq,
                "runtime": self.runtime, "ts": self.ts, **self.data}


class FlightRecorder:
    """Append-only structured solver trace (see module docstring)."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self._events: List[TraceEvent] = []
        self._pending: List[tuple] = []
        self._watched: "weakref.WeakSet" = weakref.WeakSet()
        self._seq = 0
        #: optional MetricsRegistry mirror: every event also bumps the
        #: counter ``trace.<kind>``
        self.registry = registry

    # -- host values ------------------------------------------------------------
    def record(self, kind: str, *, _runtime: bool = False, **data) -> None:
        with self._lock:
            self._events.append(TraceEvent(kind, data, self._seq, _runtime,
                                           time.time()))
            self._seq += 1
        if self.registry is not None:
            self.registry.inc(f"trace.{kind}")

    # -- device values (pending until sync) ---------------------------------------
    def emit_rows(self, kind: str, rows: torch.Tensor, names, *,
                  index: str, base: int = 0, casts=None, **static) -> None:
        """``rows.shape[0]`` runtime events from a device log, one a row:
        column j of a row is field ``names[j]`` (converted by ``casts[name]``
        when given), ``index`` is ``base`` + the row's number, and
        ``static`` is added to every event.  Read at ``sync()``, not now:
        the caller must not overwrite ``rows`` before then (hand over a
        clone of a buffer it reuses)."""
        n = int(rows.shape[0])
        with self._lock:
            self._pending.append((kind, (rows, tuple(names), index,
                                         int(base), dict(casts or {}),
                                         static), self._seq, time.time()))
            self._seq += n

    def watch(self, source) -> None:
        """Have ``sync()`` call ``source.sync()`` first: a checkpoint store
        whose writes land (and are recorded) later than they are issued
        (``store.bind_obs`` calls it)."""
        self._watched.add(source)

    def sync(self) -> None:
        """Land the watched sources' pending work, then turn every pending
        device log into events (one host read a log).  Called by
        ``events()``; call it on the thread that drives the solves."""
        for source in list(self._watched):
            source.sync()
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        made: List[TraceEvent] = []
        for kind, payload, seq, ts in pending:
            rows, names, index, base, casts, static = payload
            host = rows.detach().cpu().tolist()
            for i, row in enumerate(host):
                data = {name: casts.get(name, lambda v: v)(v)
                        for name, v in zip(names, row)}
                data[index] = base + i
                data.update(static)
                made.append(TraceEvent(kind, data, seq + i, True, ts))
        with self._lock:
            self._events.extend(made)
            self._events.sort(key=lambda e: e.seq)
        if self.registry is not None:
            for e in made:
                self.registry.inc(f"trace.{e.kind}")

    # -- access --------------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[TraceEvent]:
        self.sync()
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __len__(self) -> int:
        self.sync()
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._pending.clear()

    # -- reconstruction helpers ---------------------------------------------
    def adaptive_steps(self) -> List[Dict[str, Any]]:
        """The adaptive sweep's attempt sequence, ordered by the attempt
        counter each row carries: one dict per attempted step with t, h,
        err_norm, and accept."""
        evs = self.events("adaptive.step")
        return sorted((e.data for e in evs), key=lambda d: d["attempt"])

    def accepted_rejected(self) -> Tuple[int, int]:
        steps = self.adaptive_steps()
        acc = sum(1 for d in steps if d["accept"])
        return acc, len(steps) - acc

    def spill_traffic(self) -> Dict[str, Dict[str, Any]]:
        """Per-store, per-direction spill I/O: transfers (``*_cb``), slots,
        and payload bytes, plus the per-segment breakdown keyed by slot
        base and the per-medium byte split (``media``: "ram" vs "disk").
        ``dispatch_cb`` counts the issued prefetches (``spill.dispatch``)
        apart from the data-carrying reads."""
        out: Dict[str, Dict[str, Any]] = {}
        for e in self.events():
            if e.kind not in ("spill.write", "spill.read", "spill.free",
                              "spill.dispatch"):
                continue
            store = e.data.get("store", "?")
            s = out.setdefault(store, {
                "write_cb": 0, "read_cb": 0, "free_cb": 0, "dispatch_cb": 0,
                "write_slots": 0, "read_slots": 0,
                "write_bytes": 0, "read_bytes": 0,
                "segments": {}, "media": {}})
            if e.kind == "spill.dispatch":
                s["dispatch_cb"] += 1
                continue
            if e.kind == "spill.free":
                s["free_cb"] += 1
                continue
            medium = e.data.get("medium")
            if medium is not None:
                m = s["media"].setdefault(str(medium), {
                    "write_bytes": 0, "read_bytes": 0})
                key = ("write_bytes" if e.kind == "spill.write"
                       else "read_bytes")
                m[key] += int(e.data.get("bytes", 0))
            d = "write" if e.kind == "spill.write" else "read"
            s[f"{d}_cb"] += 1
            s[f"{d}_slots"] += int(e.data.get("slots", 1))
            s[f"{d}_bytes"] += int(e.data.get("bytes", 0))
            seg = s["segments"].setdefault(int(e.data.get("base", -1)), {
                "write_slots": 0, "read_slots": 0,
                "write_bytes": 0, "read_bytes": 0})
            seg[f"{d}_slots"] += int(e.data.get("slots", 1))
            seg[f"{d}_bytes"] += int(e.data.get("bytes", 0))
        return out

    @staticmethod
    def _expand_stacked(evs: List[TraceEvent]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for e in evs:
            base = int(e.data.get("base", 0))
            its = e.data["iters"]
            res = e.data["residual"]
            conv = e.data["converged"]
            if not isinstance(its, list):  # single-step sweep
                its, res, conv = [its], [res], [conv]
            for i in range(len(its)):
                out.append({"step": base + i, "iters": its[i],
                            "residual": res[i], "converged": conv[i]})
        return sorted(out, key=lambda d: d["step"])

    def implicit_steps(self) -> List[Dict[str, Any]]:
        """Forward-sweep Newton exit states, one dict per step ordered by
        step index, expanded from the stacked ``implicit.steps`` events
        (one a sweep)."""
        return self._expand_stacked(self.events("implicit.steps"))

    def implicit_recomputes(self) -> List[Dict[str, Any]]:
        """Reverse-sweep re-advance Newton exit states, per step."""
        return self._expand_stacked(self.events("implicit.recompute"))

    # -- export --------------------------------------------------------------
    def to_jsonl(self, path_or_sink) -> int:
        """Write every event as one JSON line; accepts a path or a
        ``MetricsSink``.  Returns the number of events written."""
        evs = self.events()
        emit = getattr(path_or_sink, "emit", None)
        if emit is not None:
            for e in evs:
                emit(f"trace.{e.kind}", **e.to_json())
            return len(evs)
        with open(path_or_sink, "a") as fh:
            for e in evs:
                fh.write(json.dumps(e.to_json()) + "\n")
        return len(evs)
