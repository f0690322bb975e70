"""``StepGraph``: capture a step once as a CUDA graph and replay it, the
port's counterpart of the JAX package's ``jax.jit`` around its hot calls
(``decode`` in ``repro/serve/engine.py``, ``value_and_grad`` of the CNF
and classifier losses in its benchmarks and examples).

A step is ``fn(held, copied)`` with two pytrees of tensors:

- ``held`` (parameters, a decode state) is captured by address.  Every
  call checks that it holds the same tensors as at the first call (tree
  structure, ``data_ptr``, shape, stride, dtype, device) and raises if
  not: a graph reads the addresses it was captured with, so a new tensor
  would be silently ignored.  Nothing is copied or captured again.
- ``copied`` (a token, a position, a data batch, parameters that the
  optimizer replaces every step) is copied into static buffers before
  each call; a tensor of another shape, dtype or device raises.

``fn`` returns a pytree of tensors.  With ``clone_outputs=False`` a call
returns the static outputs, which the next call overwrites (decode reads
its logits before the next step); with ``clone_outputs=True`` it returns
clones (the ODE gradients).

On CUDA tensors the first call warms ``fn`` up once on a side stream
(building the kernels' libraries and setting up cuBLAS/cuDNN, none of
which may happen during a capture), captures it on that stream with
``torch.cuda.graph``, and replays it; later calls replay.  The side
stream is ``torch.cuda.graph``'s own capture stream, one for every graph
of the process: cuBLAS keeps a workspace for each stream it has run on,
so a stream of each graph's own would hold a workspace each.  A capture
that fails raises: there is no eager fallback on the card.  On CPU
tensors, where the caller asked for the CPU, ``fn`` runs eagerly on the
static buffers every call, so the CPU tests cover everything but the
graph itself.  The garbage collector is held off during a capture: a
collection there can destroy an unreachable graph, which would
invalidate the capture.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["StepGraph"]


def _signature(t: torch.Tensor):
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _tensor_leaves(tree, what: str):
    leaves, spec = pytree.tree_flatten(tree)
    for x in leaves:
        if not torch.is_tensor(x):
            raise TypeError(f"StepGraph: every {what} leaf must be a tensor, "
                            f"got {type(x).__name__}")
    return leaves, spec


class StepGraph:
    """``fn(held, copied)`` captured once and replayed (module docstring).

    After the capture ``warmup_ms`` and ``capture_ms`` (host clock, each
    ending in a synchronize; the capture includes instantiating the
    graph) and ``pool_bytes`` (the device memory the capture reserved
    for its private pool) describe it; on the CPU they stay None.
    """

    def __init__(self, fn: Callable[[Any, Any], Any], *,
                 clone_outputs: bool):
        self.fn = fn
        self.clone_outputs = bool(clone_outputs)
        self.device: torch.device | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warmup_ms: float | None = None
        self.capture_ms: float | None = None
        self.pool_bytes: int | None = None
        self._held_spec = None
        self._held_sig = None
        self._in_spec = None
        self._inputs: list[torch.Tensor] | None = None
        self._outputs = None

    # -- arguments -------------------------------------------------------------
    def _bind(self, held, copied) -> None:
        """The first call: fix the held tensors and the static buffers."""
        h_leaves, self._held_spec = _tensor_leaves(held, "held")
        c_leaves, self._in_spec = _tensor_leaves(copied, "copied")
        devices = {x.device for x in h_leaves + c_leaves}
        if len(devices) != 1:
            raise ValueError("StepGraph: the held and copied tensors must lie "
                             f"on one device, got {sorted(map(str, devices))}")
        self.device = devices.pop()
        self._held_sig = [_signature(x) for x in h_leaves]
        self._inputs = [x.detach().clone() for x in c_leaves]

    def _check_held(self, held) -> None:
        leaves, spec = _tensor_leaves(held, "held")
        if spec != self._held_spec:
            raise ValueError("StepGraph: the held tree changed its structure "
                             "since the capture")
        for i, x in enumerate(leaves):
            if _signature(x) != self._held_sig[i]:
                raise ValueError(
                    f"StepGraph: held leaf {i} is not the tensor captured "
                    "(data_ptr, shape, stride, dtype or device differ); a "
                    "graph reads the addresses it was captured with, so pass "
                    "the same tensors or build a new StepGraph")

    def _copy_in(self, copied) -> None:
        leaves, spec = _tensor_leaves(copied, "copied")
        if spec != self._in_spec:
            raise ValueError("StepGraph: the copied tree changed its "
                             "structure since the capture")
        for i, (buf, x) in enumerate(zip(self._inputs, leaves)):
            if (x.shape != buf.shape or x.dtype != buf.dtype
                    or x.device != buf.device):
                raise ValueError(
                    f"StepGraph: copied leaf {i} is {x.device}/{x.dtype}/"
                    f"{tuple(x.shape)}, the static buffer "
                    f"{buf.device}/{buf.dtype}/{tuple(buf.shape)}")
        with torch.no_grad():
            for buf, x in zip(self._inputs, leaves):
                buf.copy_(x)

    def _static_args(self, held):
        return held, pytree.tree_unflatten(self._inputs, self._in_spec)

    # -- capture ---------------------------------------------------------------
    @property
    def captured(self) -> bool:
        return self._held_sig is not None and (
            self.device.type != "cuda" or self.graph is not None)

    def capture(self, held, copied) -> None:
        """Bind the arguments and, on the card, warm up and capture; no
        replay.  ``copied`` gives the static buffers their first values."""
        if self._held_sig is None:
            self._bind(held, copied)
        else:
            self._check_held(held)
        self._copy_in(copied)
        if self.device.type != "cuda" or self.graph is not None:
            return
        args = self._static_args(held)
        with torch.cuda.device(self.device):
            graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(graph)
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream())
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                self.fn(*args)
            torch.cuda.synchronize()
            self.warmup_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            # a garbage collection inside the capture may destroy another
            # graph, a CUDA call that invalidates the capture: the
            # collector is held off until the capture ends
            collecting = gc.isenabled()
            gc.disable()
            try:
                # torch.cuda.graph synchronizes and empties the cache on
                # entry, so the pool is what the reserved bytes grow by
                # inside it
                with capture:
                    reserved = torch.cuda.memory_reserved()
                    out = self.fn(*args)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            _tensor_leaves(out, "output")
        self.graph, self._outputs = graph, out

    # -- call ------------------------------------------------------------------
    def __call__(self, held, copied):
        if not self.captured:
            self.capture(held, copied)
        else:
            self._check_held(held)
            self._copy_in(copied)
        if self.device.type == "cuda":
            self.graph.replay()
            out = self._outputs
        else:
            out = self.fn(*self._static_args(held))
            leaves, _ = _tensor_leaves(out, "output")
            if not self.clone_outputs:
                # the card's contract: one set of static outputs, which the
                # next call overwrites
                if self._outputs is None:
                    self._outputs = out
                else:
                    with torch.no_grad():
                        for buf, x in zip(pytree.tree_leaves(self._outputs),
                                          leaves):
                            buf.copy_(x)
                out = self._outputs
        if self.clone_outputs:
            return pytree.tree_map(torch.Tensor.clone, out)
        return out
