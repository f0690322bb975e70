"""Gradient compression, the port of ``repro/optim/compress.py``.

Two schemes, each a (compress, decompress) pair over a gradient tree:

* ``bf16``: cast the fp32 gradients to bf16 and back, the rounding the
  reduction's wire sees.  Stateless.
* ``int8``: per-leaf symmetric int8 (``scale = max(max|g|, 1e-12) /
  127``, round half to even, clip to +-127) with error feedback: the
  residual ``g + r - deq(q)`` is carried into the next step.

On one device the schemes reproduce the numerics of the compressed
reduction; the reduction itself, ``compressed_psum``, needs a collective
axis and comes with the distributed layer (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils import _pytree as pytree

PyTree = Any


def _is_pair(x) -> bool:
    return isinstance(x, tuple)


# ---------------------------------------------------------------------------
# bf16 wire compression
# ---------------------------------------------------------------------------

def bf16_compress(grads: PyTree) -> PyTree:
    return pytree.tree_map(lambda g: g.to(torch.bfloat16), grads)


def bf16_decompress(grads: PyTree) -> PyTree:
    return pytree.tree_map(lambda g: g.to(torch.float32), grads)


# ---------------------------------------------------------------------------
# int8 + error feedback
# ---------------------------------------------------------------------------

def int8_init(grads_shape: PyTree) -> PyTree:
    """Error-feedback residual state: fp32 zeros like the grads, on their
    devices."""
    return pytree.tree_map(
        lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                              device=g.device), grads_shape)


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress(grads: PyTree, residual: PyTree):
    """Returns ((q, scale) a leaf, new_residual), new_residual = g + r -
    deq(q)."""
    g_leaves, spec = pytree.tree_flatten(grads)
    r_leaves = pytree.tree_leaves(residual)
    pairs, res = [], []
    for g, r in zip(g_leaves, r_leaves, strict=True):
        gr = g + r
        q, s = int8_quantize(gr)
        pairs.append((q, s))
        res.append(gr - int8_dequantize(q, s))
    return (pytree.tree_unflatten(pairs, spec),
            pytree.tree_unflatten(res, spec))


def int8_decompress(qs: PyTree) -> PyTree:
    return pytree.tree_map(lambda p: int8_dequantize(*p), qs,
                           is_leaf=_is_pair)


# ---------------------------------------------------------------------------
# compressed reduction
# ---------------------------------------------------------------------------

def compressed_psum(grads: PyTree, axis_name: str,
                    scheme: str = "bf16") -> PyTree:
    """The reference's all-reduce with wire compression over a mesh axis:
    not ported yet, the port has no collective axis before its distributed
    layer (ROADMAP Queue 1 item 14)."""
    raise NotImplementedError(
        "compressed_psum needs a collective axis: the distributed layer "
        "(dist/) is not ported yet (ROADMAP Queue 1 item 14)")


def wire_bytes(grads: PyTree, scheme: str = "bf16") -> int:
    """Bytes a single participant puts on the wire for one reduction."""
    per = {"none": 4, "bf16": 2, "int8": 1}[scheme]
    return sum(leaf.numel() * per for leaf in pytree.tree_leaves(grads))
