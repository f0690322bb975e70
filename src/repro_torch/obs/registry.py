"""Host-side metrics registry: counters, gauges, and histograms that every
layer of the stack reports through instead of inventing its own dict (the
JAX package's ``repro/obs/registry.py``; ``MetricsRegistry`` is a copy).

Three metric kinds, all host-side Python state guarded by one re-entrant
lock (a spill store's prefetch worker and a checkpoint commit thread may
report concurrently with a benchmark's ``reset()``):

  counter    monotonically increasing int (``inc``);
  gauge      last-written float (``set_gauge``), e.g. a queue depth;
  histogram  running (count, sum, min, max) summary (``observe``).

``snapshot()`` returns plain dicts (JSON-ready, used by the MetricsSink);
``reset()`` zeroes everything atomically.

Counting on the device (``JitCounter`` / ``FevalCounter``)
----------------------------------------------------------
The JAX package counts executions of a tap site inside a compiled program
with an identity ``pure_callback``.  The port's counterpart of a compiled
program is a CUDA graph (``launch.graphs.StepGraph``), where host code runs
at capture only: a host increment there counts once, however many replays
follow.  So ``JitCounter.tap(x)`` keeps its count in a 0-d int64 tensor on
``x``'s device and adds one to it in place (one tiny kernel, which a
capture records and every replay runs), and returns ``x`` itself.  The
count is read with one host read (``count``), which also brings the
registry counter of the same name up to date.  A tap of a host number (a
Python float step time) counts on the host.  The device counter is made at
the first tap, which must not run inside a capture (``StepGraph``'s warm-up
runs first, eagerly).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch


class MetricsRegistry:
    """Thread-safe named counters/gauges/histograms."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges -------------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    # -- histograms ---------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = {"count": 0, "sum": 0.0, "min": value, "max": value}
                self._hists[name] = h
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)

    def histogram(self, name: str) -> Optional[Dict[str, float]]:
        with self._lock:
            h = self._hists.get(name)
            return dict(h) if h is not None else None

    # -- bulk ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready copy of every metric."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: dict(v) for k, v in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: process-wide default registry; library code takes an explicit registry
#: and defaults to this one
DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT_REGISTRY


#: the dispatch keys that route an op into the torch.func interpreters
_KEYS = torch._C.DispatchKey
_FUNCTORCH_LAYERS = (
    torch._C.DispatchKeySet(_KEYS.FuncTorchDynamicLayerFrontMode)
    | torch._C.DispatchKeySet(_KEYS.FuncTorchDynamicLayerBackMode))


class JitCounter:
    """Count executions of a tap site, replays of a captured graph included
    (module docstring).  ``tap(x)`` returns ``x`` unchanged, so the
    computation and its gradients are the untapped ones; ``count`` reads
    the device counters (one host read each) and mirrors the growth since
    the last read into ``registry`` under ``name`` when one is given."""

    def __init__(self, name: str = "jit_counter",
                 registry: Optional[MetricsRegistry] = None):
        self.name = name
        self._registry = registry
        self._host = 0
        self._dev: Dict[torch.device, torch.Tensor] = {}
        self._mirrored = 0

    def _counter(self, device: torch.device) -> torch.Tensor:
        c = self._dev.get(device)
        if c is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"JitCounter {self.name!r}: the first tap on {device} "
                    "runs inside a CUDA-graph capture; tap once eagerly "
                    "first (StepGraph's warm-up does)")
            c = self._dev[device] = torch.zeros((), dtype=torch.int64,
                                                device=device)
        return c

    def tap(self, x):
        if torch.is_tensor(x):
            c = self._counter(x.device)
            # outside any torch.func transform the tap runs in (a vjp of f
            # in a reverse sweep), which refuses in-place writes to tensors
            # it did not create: the counter is not part of what it
            # differentiates
            with torch._C._ExcludeDispatchKeyGuard(_FUNCTORCH_LAYERS):
                c.add_(1)
        else:
            self._host += 1
        return x

    @property
    def count(self) -> int:
        n = self._host + sum(int(c) for c in self._dev.values())
        if self._registry is not None and n > self._mirrored:
            self._registry.inc(self.name, n - self._mirrored)
        self._mirrored = max(self._mirrored, n)
        return n

    def reset(self) -> None:
        """Zero the count; the device counters keep their addresses, so a
        graph captured with them counts on."""
        self._host = 0
        self._mirrored = 0
        for c in self._dev.values():
            c.zero_()


class FevalCounter:
    """Wrap a vector field so each evaluation taps its ``t`` (a
    ``JitCounter``): on the device when ``t`` is a tensor (the adaptive
    solver's), on the host when it is a Python float.  ``t`` is not
    differentiated, so the wrapped f linearizes exactly like the
    original."""

    def __init__(self, f: Callable, name: str = "nfe",
                 registry: Optional[MetricsRegistry] = None):
        self._f = f
        self._tap = JitCounter(name, registry)

    @property
    def count(self) -> int:
        return self._tap.count

    def reset(self) -> None:
        self._tap.reset()

    def __call__(self, u, theta, t):
        return self._f(u, theta, self._tap.tap(t))
