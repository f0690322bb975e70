"""Plain PyTorch versions of the port's kernels.

The wrappers in ``kernels/ops.py`` use these for tensors on the CPU; on
the card they are the oracle the kernels are held against, bitwise."""
from __future__ import annotations


def lincomb_plain(base, terms, weights, scale=None, base_coeff=None):
    """Plain version of ``ops.fused_lincomb``: the unfused eager chain,
    base first, then the terms left to right.

    Written as ``acc + c * t`` so that every multiply and every add rounds
    on its own; ``torch.add(acc, t, alpha=c)`` and ``addcmul`` contract the
    pair into an FMA on the card and would be a different function.
    ``scale`` is None, a Python number (folded into the coefficients as a
    Python double, as the static kernel form does) or a 0-dim tensor h
    (the coefficient is the tensor product ``h * w``, as the scaled form).
    """
    acc = base if base_coeff is None else base_coeff * base
    for w, t in zip(weights, terms):
        c = w if scale is None else scale * w
        acc = acc + c * t
    return acc
