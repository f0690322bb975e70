"""Perfetto / chrome://tracing export of the observability streams (a copy
of the JAX package's ``repro/obs/trace_export.py``: plain Python).

Turns the flight recorder's structured events (or their JSONL dumps —
``FlightRecorder.to_jsonl`` / ``MetricsSink`` files) into the Chrome
trace-event JSON format that https://ui.perfetto.dev and
chrome://tracing load directly:

  PYTHONPATH=src python -m repro_torch.obs.trace_export METRICS.jsonl trace.json

Every recorded event becomes an *instant* event on a track named after
its kind, grouped into process rows by subsystem — ``solver`` (odeint /
adaptive / implicit / newton), ``spill`` (checkpoint-store traffic),
``serve`` (queue + engine events), ``misc`` for the rest.  On top of the
instants the exporter synthesizes *counter* tracks, which is where the
timeline gets readable:

  ``spill bytes``     cumulative write/read payload bytes per store
  ``queue depth``     the serve queue's depth gauge over time
  ``adaptive h``      the adaptive controller's step size per attempt

Timestamps come from the host wall clock each ``TraceEvent`` now carries
(``ts``, seconds); records without one (older JSONL dumps) fall back to
their ``seq`` so ordering survives even when the absolute timeline is
unknown.  The export is a pure host-side transform — it never touches a
live solve.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["to_chrome_trace", "export_chrome_trace", "read_events"]

_SOLVER_PREFIXES = ("odeint", "adaptive", "implicit", "newton", "revolve",
                    "plan")
_SPILL_PREFIXES = ("spill",)
_SERVE_PREFIXES = ("queue", "serve")

# stable pid per subsystem row (Perfetto sorts by pid)
_PIDS = {"solver": 1, "spill": 2, "serve": 3, "misc": 4}


def _subsystem(kind: str) -> str:
    head = kind.split(".", 1)[0]
    if head in _SPILL_PREFIXES:
        return "spill"
    if head in _SERVE_PREFIXES:
        return "serve"
    if head in _SOLVER_PREFIXES:
        return "solver"
    return "misc"


def _micros(rec: Dict[str, Any]) -> float:
    ts = rec.get("ts")
    if ts:
        return float(ts) * 1e6
    # no wall clock (older dump): seq keeps relative order, 1 us apart
    return float(rec.get("seq", 0))


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL file of trace/metrics records.  Accepts both
    ``FlightRecorder.to_jsonl`` lines (``kind`` field, possibly prefixed
    ``trace.<kind>`` when routed through a ``MetricsSink``) and plain
    sink records (``event`` field)."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "kind" not in rec:
                ev = rec.get("event")
                if ev is None:
                    continue
                rec = dict(rec, kind=ev)
            kind = rec["kind"]
            if kind.startswith("trace."):
                rec = dict(rec, kind=kind[len("trace."):])
            out.append(rec)
    return out


def to_chrome_trace(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` envelope)
    from an iterable of event dicts (``TraceEvent.to_json()`` shape)."""
    trace: List[Dict[str, Any]] = []
    named_rows: set = set()
    counters: Dict[str, Dict[str, float]] = {}  # name -> running totals

    def row(sub: str) -> int:
        pid = _PIDS[sub]
        if sub not in named_rows:
            named_rows.add(sub)
            trace.append({"ph": "M", "pid": pid, "name": "process_name",
                          "args": {"name": sub}})
        return pid

    def counter(sub: str, name: str, ts: float,
                values: Dict[str, float]) -> None:
        trace.append({"ph": "C", "pid": row(sub), "name": name, "ts": ts,
                      "args": {k: float(v) for k, v in values.items()}})

    for rec in events:
        kind = rec.get("kind")
        if not kind:
            continue
        sub = _subsystem(kind)
        ts = _micros(rec)
        args = {k: v for k, v in rec.items()
                if k not in ("kind", "ts") and _jsonable(v)}
        trace.append({"ph": "i", "s": "t", "pid": row(sub), "tid": kind,
                      "name": kind, "ts": ts, "cat": sub, "args": args})
        # counter synthesis
        if kind in ("spill.write", "spill.read"):
            store = str(rec.get("store", "?"))
            tot = counters.setdefault(f"spill bytes [{store}]",
                                      {"write": 0.0, "read": 0.0})
            d = "write" if kind == "spill.write" else "read"
            tot[d] += float(rec.get("bytes", 0) or 0)
            counter("spill", f"spill bytes [{store}]", ts, tot)
        elif kind in ("queue.submit", "queue.schedule", "queue.reject"):
            depth = rec.get("depth")
            if depth is not None:
                counter("serve", "queue depth", ts,
                        {"depth": float(depth)})
        elif kind == "adaptive.step":
            h = rec.get("h")
            if h is not None:
                counter("solver", "adaptive h", ts, {"h": float(h)})
        elif kind == "serve.batch":
            occ = rec.get("occupancy")
            if occ is not None:
                counter("serve", "batch occupancy", ts,
                        {"occupancy": float(occ)})
    # the exporter tag is the JAX package's, so that both packages write
    # the same document for the same events
    return {"traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro.obs.trace_export"}}


def _jsonable(v) -> bool:
    return isinstance(v, (str, int, float, bool, list, dict, type(None)))


def export_chrome_trace(src, path: str) -> int:
    """Write a Perfetto-loadable trace JSON for ``src`` — a
    ``FlightRecorder``, a JSONL file path, or an iterable of event dicts.
    Returns the number of trace entries written."""
    events = getattr(src, "events", None)
    if callable(events):  # FlightRecorder
        recs: Iterable[Dict[str, Any]] = [e.to_json() for e in events()]
    elif isinstance(src, str):
        recs = read_events(src)
    else:
        recs = src
    doc = to_chrome_trace(recs)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Export JSONL flight-recorder/metrics records to "
                    "Chrome trace-event JSON (Perfetto-loadable)")
    ap.add_argument("jsonl", help="input JSONL (FlightRecorder.to_jsonl or "
                                  "MetricsSink output)")
    ap.add_argument("out", help="output trace JSON path")
    args = ap.parse_args(argv)
    n = export_chrome_trace(args.jsonl, args.out)
    print(f"[trace_export] wrote {n} trace entries -> {args.out}")


if __name__ == "__main__":
    main()
