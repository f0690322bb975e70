"""Plain PyTorch versions of the port's kernels.

The wrappers in ``kernels/ops.py`` use these for tensors on the CPU; on
the card they are the oracle the kernels are held against: bitwise for
``fused_lincomb``, within a stated tolerance for the flash kernel, whose
sums run in another order."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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


def attend_mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Sk) bool, True where the query at ``q_pos`` may attend the key
    at ``k_pos``: causal means key <= query; window > 0 also means key >
    query - window.  The one mask rule of the port's attention paths."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = dk <= dq
    if window > 0:
        ok = ok & (dk > dq - window)
    return ok


def attention_plain(q, k, v, *, causal=True, window=0):
    """Plain version of ``ops.flash_attention_bhsd`` and the counterpart of
    the JAX package's ``attention_ref``.  q: (B,H,Sq,Dh); k, v:
    (B,Hkv,Sk,Dh).  Repeated kv heads, fp32 scores scaled by 1/sqrt(Dh),
    the finite ``NEG_INF`` mask of ``attend_mask``, softmax, output in q's
    dtype."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    ok = attend_mask(torch.arange(sq, device=q.device),
                     torch.arange(sk, device=q.device), causal, window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
