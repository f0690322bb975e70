"""repro_torch.obs: the observability layer (the JAX package's
``repro.obs``): metrics registry, device counters, the solver flight
recorder, JSONL metrics sink, profiler annotations, and the unified
benchmark-baseline checker.

Attach a ``FlightRecorder`` to a solve with the ``obs=`` knob:

    rec = FlightRecorder()
    u = odeint(f, u0, theta, dt=..., n_steps=..., obs=rec)
    rec.events("spill.write"); rec.adaptive_steps(); rec.spill_traffic()

With ``obs=None`` (default) nothing is recorded, copied or read.
"""
from repro_torch.obs.baseline import (BaselineRef, Gate,
                                      check_against_baseline, lookup)
from repro_torch.obs.registry import (DEFAULT_REGISTRY, FevalCounter,
                                      JitCounter, MetricsRegistry,
                                      default_registry)
from repro_torch.obs.sink import MetricsSink, StructuredLogger, read_jsonl
from repro_torch.obs.trace import FlightRecorder, TraceEvent
from repro_torch.obs.trace_export import export_chrome_trace, to_chrome_trace
from repro_torch.obs.profile import host_annotation, scope

__all__ = [
    "BaselineRef", "Gate", "check_against_baseline", "lookup",
    "DEFAULT_REGISTRY", "FevalCounter", "JitCounter", "MetricsRegistry",
    "default_registry",
    "MetricsSink", "StructuredLogger", "read_jsonl",
    "FlightRecorder", "TraceEvent",
    "export_chrome_trace", "to_chrome_trace",
    "host_annotation", "scope",
]
