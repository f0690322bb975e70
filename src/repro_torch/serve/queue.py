"""Request queue + continuous-batching scheduler, the port of
``repro/serve/queue.py`` (numpy and threading there already), with its
``serve.request`` fault site (``fault_plan=``), its metrics
(``registry=``: the ``serve.submitted``/``serve.rejected`` counters and
the ``serve.queue_depth`` gauge) and its events (``obs=``:
``queue.submit``, ``queue.reject``, ``queue.schedule``).

Deterministic by construction: scheduling state advances in logical
*ticks* (one per ``next_batch`` call), never on the wall clock, so a
replayed request stream schedules identically.

Admission (``submit``) validates a request before it can occupy queue
space: known ``kind``, payload rank/width matching the engine's contract,
a byte cap on the payload, and finite values (a NaN/inf payload would
poison every other lane of the batch it joins).

Scheduling (``next_batch``) is FIFO-with-aging: a request's effective
score is ``priority + aging * (tick - enqueue_tick)``, ties broken by
arrival order.  With ``aging > 0`` any bounded-priority stream cannot
starve a waiting request.  Batches are homogeneous in ``kind``: the
scheduler picks the top-scored request's kind and fills the batch with
same-kind requests in score order.

Batch buckets (``BucketSpec``): an engine pads the lane dimension up to
the chosen bucket, so the set of batch shapes it runs is bounded by
``len(sizes) * len(kinds)`` regardless of traffic.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AdmissionError", "BucketSpec", "Request", "RequestQueue",
           "Ticket"]


class AdmissionError(ValueError):
    """Request rejected at the door (malformed, oversized, unknown kind,
    or non-finite payload)."""


@dataclass(frozen=True)
class BucketSpec:
    """Fixed set of batch shapes.  ``bucket_for(n)`` returns the smallest
    bucket holding ``n`` lanes (the largest bucket when ``n`` exceeds every
    size: the scheduler never hands out more than ``max(sizes)`` requests
    at once)."""

    sizes: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        sizes = tuple(sorted(set(int(s) for s in self.sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.sizes}")
        object.__setattr__(self, "sizes", sizes)

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]


@dataclass
class Request:
    rid: str
    kind: str
    payload: np.ndarray
    priority: float = 0.0
    enqueue_tick: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)


class Ticket:
    """Caller-facing completion handle (a tiny future): ``result()``
    blocks until the engine resolves the request, re-raising a
    request-level error without implicating the rest of its batch."""

    def __init__(self, rid: str, enqueue_tick: int):
        self.rid = rid
        self.enqueue_tick = enqueue_tick
        self.complete_tick: Optional[int] = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_ticks(self) -> Optional[int]:
        if self.complete_tick is None:
            return None
        return self.complete_tick - self.enqueue_tick

    def set_result(self, value: Any, tick: int) -> None:
        self._result = value
        self.complete_tick = tick
        self._event.set()

    def set_error(self, err: BaseException, tick: int) -> None:
        self._error = err
        self.complete_tick = tick
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending")
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """Admission + FIFO-with-aging scheduling (see module docstring).

    ``dim``/``max_payload_bytes`` define the admission contract for array
    payloads; ``kinds`` the accepted request kinds; ``aging`` the
    ticks-to-priority exchange rate (0 disables aging: strict priority,
    which CAN starve; the default 1.0 cannot).  ``fault_plan`` arms the
    ``serve.request`` site; ``registry`` (a ``MetricsRegistry``) receives
    ``serve.submitted``/``serve.rejected`` counters and the
    ``serve.queue_depth`` gauge; ``obs`` (a ``FlightRecorder``) receives
    ``queue.submit``/``queue.reject``/``queue.schedule`` events."""

    def __init__(self, *, kinds: Sequence[str], dim: Optional[int] = None,
                 max_payload_bytes: int = 1 << 20, aging: float = 1.0,
                 fault_plan=None, registry=None, obs=None):
        self.kinds = tuple(kinds)
        self.dim = dim
        self.max_payload_bytes = int(max_payload_bytes)
        self.aging = float(aging)
        self.fault_plan = fault_plan
        self.registry = registry
        self.obs = obs
        self._lock = threading.Lock()
        self._pending: List[Tuple[Request, Ticket]] = []
        self._tick = 0
        self._seq = itertools.count()

    # -- introspection -------------------------------------------------------
    @property
    def tick(self) -> int:
        with self._lock:
            return self._tick

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- admission -----------------------------------------------------------
    def _validate(self, kind: str, payload) -> np.ndarray:
        if self.fault_plan is not None:
            spec = self.fault_plan.tick("serve.request")
            if spec is not None and spec.kind == "malformed":
                raise AdmissionError(
                    "rejected: injected malformed request (serve.request)")
            if spec is not None and spec.kind == "oversize":
                raise AdmissionError(
                    "rejected: injected oversized request (serve.request)")
        if kind not in self.kinds:
            raise AdmissionError(
                f"rejected: unknown kind {kind!r}; one of {self.kinds}")
        arr = np.asarray(payload)
        if not np.issubdtype(arr.dtype, np.floating) and \
                not np.issubdtype(arr.dtype, np.integer):
            raise AdmissionError(
                f"rejected: payload dtype {arr.dtype} is not numeric")
        if arr.nbytes > self.max_payload_bytes:
            raise AdmissionError(
                f"rejected: payload {arr.nbytes} B exceeds the "
                f"{self.max_payload_bytes} B cap")
        if self.dim is not None:
            if arr.ndim != 1 or arr.shape[0] != self.dim:
                raise AdmissionError(
                    f"rejected: payload shape {arr.shape} != ({self.dim},)")
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.all(np.isfinite(arr)):
            raise AdmissionError(
                "rejected: non-finite payload would poison its batch")
        return arr

    def submit(self, kind: str, payload, *, priority: float = 0.0,
               rid: Optional[str] = None,
               meta: Optional[Dict[str, Any]] = None) -> Ticket:
        """Admit one request; raises ``AdmissionError`` on rejection.
        Returns a ``Ticket`` the engine resolves."""
        try:
            arr = self._validate(kind, payload)
        except AdmissionError:
            if self.registry is not None:
                self.registry.inc("serve.rejected")
            if self.obs is not None:
                self.obs.record("queue.reject", _runtime=True, req_kind=kind)
            raise
        with self._lock:
            n = next(self._seq)
            rid = rid if rid is not None else f"req-{n}"
            req = Request(rid, kind, arr, float(priority), self._tick,
                          dict(meta or {}))
            ticket = Ticket(rid, self._tick)
            self._pending.append((req, ticket))
            depth = len(self._pending)
        if self.registry is not None:
            self.registry.inc("serve.submitted")
            self.registry.set_gauge("serve.queue_depth", depth)
        if self.obs is not None:
            self.obs.record("queue.submit", _runtime=True, rid=rid,
                            req_kind=kind, priority=float(priority),
                            depth=depth)
        return ticket

    # -- scheduling ----------------------------------------------------------
    def _score(self, req: Request) -> float:
        return req.priority + self.aging * (self._tick - req.enqueue_tick)

    def next_batch(self, capacity: int,
                   kind: Optional[str] = None
                   ) -> List[Tuple[Request, Ticket]]:
        """Claim up to ``capacity`` same-kind requests by descending
        effective score (ties: arrival order).  ``kind=None`` uses the
        top-scored request's kind.  Advances the logical tick."""
        with self._lock:
            self._tick += 1
            if not self._pending:
                return []
            order = sorted(
                range(len(self._pending)),
                key=lambda i: (-self._score(self._pending[i][0]), i))
            if kind is None:
                kind = self._pending[order[0]][0].kind
            take = [i for i in order
                    if self._pending[i][0].kind == kind][:int(capacity)]
            taken = set(take)
            batch = [self._pending[i] for i in take]
            self._pending = [p for i, p in enumerate(self._pending)
                             if i not in taken]
            depth = len(self._pending)
            tick = self._tick
        if self.registry is not None:
            self.registry.set_gauge("serve.queue_depth", depth)
        if self.obs is not None and batch:
            self.obs.record("queue.schedule", _runtime=True, tick=tick,
                            req_kind=kind, batch=[r.rid for r, _ in batch],
                            waited=[tick - r.enqueue_tick for r, _ in batch],
                            depth=depth)
        return batch
