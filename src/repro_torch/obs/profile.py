"""Profiler annotations (the JAX package's ``repro/obs/profile.py``).

``scope(name)`` marks a solver sweep and ``host_annotation(name)`` a spill
store's host work; both open ``torch.profiler.record_function("obs:<name>")``
so a ``torch.profiler`` trace shows ``obs:adjoint/fwd``,
``obs:spill/write`` frames.  The JAX package needs two mechanisms (a
``jax.named_scope`` stamped into traced code, a ``TraceAnnotation`` around
host callbacks); here the host runs every sweep, so both are one.

Each is a no-op unless a profiler is recording: the eager sweeps run one
annotation a step, which must cost nothing when no one traces.  Both work
as a context manager and as a decorator.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "obs"


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Annotation(contextlib.ContextDecorator):
    def __init__(self, name: str):
        self.name = f"{PREFIX}:{name}"
        self._rf = None

    def _recreate_cm(self):
        # a decorated function may run recursively or on several threads
        return _Annotation(self.name[len(PREFIX) + 1:])

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False


def scope(name: str) -> _Annotation:
    """A solver sweep's annotation: ``with scope("adjoint/bwd"): ...`` or
    ``@scope("adjoint/bwd")``."""
    return _Annotation(name)


def host_annotation(name: str) -> _Annotation:
    """A store's host work: ``with host_annotation("spill/write"): ...``."""
    return _Annotation(name)
