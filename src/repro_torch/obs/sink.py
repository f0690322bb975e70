"""JSONL metrics sink + structured logger (a copy of the JAX package's
``repro/obs/sink.py``: plain Python).

``MetricsSink`` appends one JSON object per ``emit`` to a file — the
machine-readable channel the launch layer reports through (per-step train
records, serve stats, benchmark records) and CI uploads as an artifact.
Records carry an ``event`` name, a monotonically increasing ``seq``, and a
wall-clock ``ts``; writes are lock-guarded and flushed per record so a
crashed run keeps every completed line.

``StructuredLogger`` is the human+machine bridge that replaces the bare
``print`` calls in ``launch/train.py`` / ``launch/dryrun.py``: each
``.log(event, msg, **fields)`` writes the formatted line through ``log_fn``
(default ``print``; tests pass a no-op, exactly as they did before) AND
emits the structured record to the sink when one is attached.  Either side
can be switched off independently.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            import numpy as np
            a = np.asarray(v)
            return a.item() if a.ndim == 0 else a.tolist()
        except Exception:
            return repr(v)


class MetricsSink:
    """Append-only JSONL writer; one JSON object per ``emit``."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.RLock()
        self._seq = 0
        self._fh = open(self.path, "a")

    def emit(self, event: str, **fields) -> Dict[str, Any]:
        rec = {"event": event, "ts": time.time(),
               **{k: _jsonable(v) for k, v in fields.items()}}
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL file back into a list of dicts (skips blank lines)."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class StructuredLogger:
    """Route a message to both a human line (via ``log_fn``) and a JSONL
    record (via ``sink``); either may be None."""

    def __init__(self, log_fn: Optional[Callable[[str], None]] = print,
                 sink: Optional[MetricsSink] = None):
        self.log_fn = log_fn
        self.sink = sink

    def log(self, event: str, msg: str, **fields) -> None:
        if self.log_fn is not None:
            self.log_fn(msg)
        if self.sink is not None:
            self.sink.emit(event, msg=msg, **fields)

    def metric(self, event: str, **fields) -> None:
        """Sink-only record (no human line) — per-step metrics."""
        if self.sink is not None:
            self.sink.emit(event, **fields)
