"""Unified benchmark-baseline regression checker (a copy of the JAX
package's ``repro/obs/baseline.py``: plain Python).

``benchmarks/hotpath.py`` (BENCH_3) and ``benchmarks/stiff_ensemble.py``
(BENCH_4) used to each carry a bespoke comparator; CI now routes both
through this one: a benchmark declares its gates as data
(``Gate(path, op, ref=...)`` against the measured record, with thresholds
optionally read from the recorded baseline JSON) and
``check_against_baseline`` evaluates them, returning human-readable error
strings and mirroring pass/fail counts into the metrics registry
(``baseline.<bench>.pass|fail``) so the smoke run's JSONL artifact records
which gates tripped.

Paths are dotted lookups into the record (``"spill_io.callbacks"``); a
``*`` segment fans out over every key of a dict (``"fused.*.bitwise"`` —
ALL fanned-out values must pass).  ``ref`` is a literal, or
``BaselineRef("key.path")`` to read the threshold from the baseline dict.
A gate with ``precondition=True`` short-circuits: if it fails, its message
is returned alone and no other gate runs (used for "baseline recorded for
a different problem size" guards where every other comparison would be
meaningless).
"""
from __future__ import annotations

import json
import operator
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

_MISSING = object()

_OPS: Dict[str, Callable[[Any, Any], bool]] = {
    "<=": operator.le,
    "<": operator.lt,
    ">=": operator.ge,
    ">": operator.gt,
    "==": operator.eq,
    "!=": operator.ne,
    "truthy": lambda v, _: bool(v),
    "falsy": lambda v, _: not bool(v),
}


def lookup(record: Any, path: str) -> List[Tuple[str, Any]]:
    """Resolve a dotted path; ``*`` fans out over dict keys.  Returns
    ``[(concrete_path, value), ...]`` — value is ``_MISSING`` if absent."""
    results: List[Tuple[str, Any]] = [("", record)]
    for seg in path.split("."):
        nxt: List[Tuple[str, Any]] = []
        for pfx, cur in results:
            if cur is _MISSING:
                nxt.append((pfx, _MISSING))
            elif seg == "*":
                if isinstance(cur, dict):
                    for k, v in cur.items():
                        nxt.append((f"{pfx}.{k}".lstrip("."), v))
                else:
                    nxt.append((f"{pfx}.*".lstrip("."), _MISSING))
            elif isinstance(cur, dict) and seg in cur:
                nxt.append((f"{pfx}.{seg}".lstrip("."), cur[seg]))
            elif isinstance(cur, (list, tuple)) and seg.lstrip("-").isdigit():
                i = int(seg)
                v = cur[i] if -len(cur) <= i < len(cur) else _MISSING
                nxt.append((f"{pfx}.{seg}".lstrip("."), v))
            else:
                nxt.append((f"{pfx}.{seg}".lstrip("."), _MISSING))
        results = nxt
    return results


@dataclass(frozen=True)
class BaselineRef:
    """Threshold read from the baseline JSON at this dotted path."""
    path: str


@dataclass(frozen=True)
class Gate:
    """One regression gate: ``lookup(record, path) <op> ref``."""
    name: str
    path: str
    op: str  # one of _OPS
    ref: Any = None  # literal, or BaselineRef into the baseline dict
    message: str = ""  # extra context appended to the failure line
    precondition: bool = False  # failure short-circuits remaining gates

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown gate op {self.op!r}; "
                             f"expected one of {sorted(_OPS)}")


def _resolve_ref(ref: Any, baseline: Optional[dict]) -> Any:
    if isinstance(ref, BaselineRef):
        if baseline is None:
            return _MISSING
        hits = lookup(baseline, ref.path)
        return hits[0][1] if hits else _MISSING
    return ref


def check_against_baseline(
        record: dict,
        gates: Sequence[Gate],
        baseline: Union[dict, str, Path, None] = None,
        *,
        bench: str = "bench",
        registry=None) -> List[str]:
    """Evaluate every gate against ``record``; returns failure messages
    (empty list == all gates passed).  ``baseline`` may be a dict, a path
    to a JSON file, or None (then any ``BaselineRef`` gate fails with a
    missing-baseline message)."""
    if isinstance(baseline, (str, Path)):
        p = Path(baseline)
        if not p.exists():
            return [f"baseline file missing: {p}"]
        baseline = json.loads(p.read_text())

    errs: List[str] = []
    npass = 0
    for g in gates:
        ref = _resolve_ref(g.ref, baseline)
        if ref is _MISSING:
            errs.append(f"[{g.name}] baseline has no "
                        f"{g.ref.path!r} (needed by gate {g.path!r})")
            continue
        gate_errs: List[str] = []
        for cpath, val in lookup(record, g.path):
            if val is _MISSING:
                gate_errs.append(f"[{g.name}] record has no {cpath!r}")
                continue
            if not _OPS[g.op](val, ref):
                want = (f" {g.op} {ref}" if g.op not in ("truthy", "falsy")
                        else f" is not {g.op}")
                extra = f" — {g.message}" if g.message else ""
                gate_errs.append(f"[{g.name}] {cpath} = {val!r}{want}{extra}")
        if gate_errs and g.precondition:
            # the rest of the gates are meaningless; report only this
            if registry is not None:
                registry.inc(f"baseline.{bench}.skipped")
            return gate_errs
        errs.extend(gate_errs)
        npass += not gate_errs
    if registry is not None:
        registry.inc(f"baseline.{bench}.pass", npass)
        registry.inc(f"baseline.{bench}.fail", len(gates) - npass)
    return errs
