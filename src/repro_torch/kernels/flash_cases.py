"""The flash kernels' test cases, shared by ``chip_smoke.py`` and the tests:
the grid, its seeded inputs, and the limits that hold
``flash_attention_bhsd`` against ``attention_plain``.

fp32 (the CUDA-core kernel, the TPU kernel's arithmetic): ``FLASH_TOL``,
rtol = atol = 2e-5, the limit of the JAX package's kernel tests
(tests/test_kernels.py); ``fp32_ratio`` measures against it.

bf16 (the tensor-core kernel): an elementwise limit derived from the
kernel's arithmetic, ``bf16_limit``.  ``attention_plain`` computes fp32
scores from the bf16 inputs, an fp32 softmax and an fp32 P.V, and rounds
the output to bf16 once.  The kernel differs from it in three ways:

1. its p is rounded to bf16 once before P.V (l is summed from the fp32
   p), a relative error of at most u = 2**-8 per term, so at most
   2**-8 * A on the output, where A = sum_j p_j |v_j| / l is
   ``attention_plain(q, k, |v|)`` in fp32;
2. it rounds its fp32 output to bf16 once, as the plain version does:
   the two roundings of nearby values differ by at most one bf16 ulp of
   the plain output, ``ulp_bf16(plain)``;
3. its fp32 sums run in another order (first order, relative to A):
   - a score is a dot of Dh exact products; each side's sum errs by at
     most (Dh + 1) 2**-23 T (2**-23: the tensor cores may truncate),
     where T = max_ij scale * sum_d |q_id k_jd| bounds every score; the
     folded scale * log2(e) multiply and the subtraction of the row max
     add 2 * 2**-23 T on each side.  A row's p_j moves by the error of
     its own score minus the max's: 4 (Dh + 3) 2**-23 T in all;
   - exp2 on the special-function unit against an exact exp: 2**-22
     relative, 2 * 2**-23;
   - l, P.V and the per-tile rescale are fp32 sums of at most Sk terms
     on each side: 3 Sk 2**-23;
   - the epilogue's reciprocal of l and product (attention_plain
     divides) and the rounding slack: 14 * 2**-23.
   So the reorder term is c * 2**-20 * A with
   c = (4 (Dh + 3) T + 3 Sk + 16) / 8, fixed per case by its sum lengths
   and its score bound (about 1,000 at the slice's shape, a quarter of
   the rounding term).

Hence, elementwise,

    |out - plain| <= ulp_bf16(plain) + (2**-8 + c * 2**-20) * A.

The limit is tight where attention is sharp (A close to |out|) and loose
only where p is diffuse.  It must reject wrong answers: each of
``WRONG_ANSWERS`` exceeds it by ``WRONG_MARGIN`` at some element of the
grid (the CPU tests and ``chip_smoke.py`` check it).  ``flash_tc_emulated``
is a plain-torch emulation of the kernel's rounding (its tiles, online
softmax, fp32 m and l, p rounded to bf16 once); the tests use it to show
that the limit admits the kernel's arithmetic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ops import FLASH_HEAD_DIMS
from repro_torch.kernels.ref import (NEG_INF, attend_mask, attention_plain,
                                     limit_ratio)

#: the fp32 kernel against attention_plain (tests/test_kernels.py)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
#: a deliberately wrong answer must exceed the bf16 limit this many times
WRONG_MARGIN = 10
#: (B, H, Hkv, S, Dh) of the JAX package's kernel grid
#: (tests/test_kernels.py: MHA, GQA 2:1, MQA, ragged S, wide head)
FLASH_GRID = [(1, 4, 4, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 256, 32),
              (1, 4, 4, 200, 64), (1, 2, 2, 64, 128)]
#: (B, H, Hkv, Sq, Sk, Dh): the grid, cross lengths, every head dim at a
#: ragged S
FLASH_SHAPES = ([(b, h, hkv, s, s, dh) for b, h, hkv, s, dh in FLASH_GRID]
                + [(1, 4, 4, 64, 192, 64)]
                + [(2, 4, 2, 150, 150, dh) for dh in FLASH_HEAD_DIMS])
#: (causal, window): causal, causal + window, bidirectional, window only
FLASH_MASKS = [(True, 0), (True, 48), (False, 0), (False, 48)]
#: ((B, H, Hkv, Sq, Sk, Dh), causal, window): ragged tails and Sq != Sk
#: at every head dim (Sq > Sk causal: the late rows see every key)
FLASH_RAGGED = [c for dh in FLASH_HEAD_DIMS
                for c in (((1, 2, 1, 70, 70, dh), True, 16),
                          ((1, 2, 2, 33, 161, dh), False, 0),
                          ((1, 2, 2, 161, 33, dh), True, 0))]
#: score scales of the inputs: randn q and k give scores of about unit
#: spread (diffuse attention); 8 gives the sharp attention of trained
#: models, where the limit is tightest
FLASH_SHARPNESS = (1.0, 8.0)
#: (B, H, Hkv, S, Dh) of the LM slice: TinyLlama-1.1B's attention at
#: batch 8, prompt 1920
FLASH_SLICE = (8, 32, 4, 1920, 64)
#: (B, H, Hkv, S, Dh) and window of Mixtral-8x7B's prefill: batch 8, prompt
#: 2048, GQA 4:1, dh 128, sliding window 4096 (the bf16 kernel at dh 128)
FLASH_MIXTRAL = (8, 32, 8, 2048, 128)
FLASH_MIXTRAL_WINDOW = 4096


def flash_inputs(b, h, hkv, sq, sk, dh, rng, *, device="cpu",
                 dtype=torch.float32, sharpness=1.0, layout="bhsd"):
    """randn q (scaled by ``sharpness``), k and v in (B,H,S,Dh) or, with
    ``layout="bshd"``, the model's (B,S,H,Dh), drawn on the host from the
    numpy ``RandomState`` ``rng`` and moved to ``device``."""
    if layout == "bhsd":
        shapes = ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))
    else:
        shapes = ((b, sq, h, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               for shape in shapes)
    return [t.mul(m).to(device=device, dtype=dtype)
            for t, m in ((q, sharpness), (k, 1.0), (v, 1.0))]


def key_tile(dh: int) -> int:
    """Keys a tile of the bf16 kernel: 128 at a padded head dim of 64,
    else 64."""
    return 128 if dh <= 64 else 64


def ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (fp64): 2**(floor(log2|x|) - 7); at 0 the
    smallest subnormal's."""
    _, e = torch.frexp(x.double())
    return torch.where(x == 0, torch.tensor(2.0 ** -133, dtype=torch.float64),
                       torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                                   e - 8))


def reorder_c(q, k) -> float:
    """c of the reorder term c * 2**-20 (see the module docstring)."""
    dh, sk = q.shape[-1], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    qa = q.float().abs()
    ka = k.float().abs().repeat_interleave(rep, dim=1)
    t = float(torch.einsum("bhqd,bhkd->bhqk", qa, ka).amax()) / math.sqrt(dh)
    return (4 * (dh + 3) * t + 3 * sk + 16) / 8


def bf16_limit(q, k, v, plain, *, causal=True, window=0):
    """The elementwise bf16 limit (fp64) on |out - plain|, with ``plain``
    = ``attention_plain(q, k, v)`` in bf16 (see the module docstring)."""
    a = attention_plain(q.float(), k.float(), v.float().abs(),
                        causal=causal, window=window).double()
    return ulp_bf16(plain.float()) + (2.0 ** -8 + reorder_c(q, k)
                                      * 2.0 ** -20) * a


def fp32_ratio(out, plain):
    """max |out - plain| / (atol + rtol |plain|) at ``FLASH_TOL``: <= 1 is
    within the fp32 limit."""
    return limit_ratio(out, plain, **FLASH_TOL)


def bf16_ratio(out, q, k, v, *, causal=True, window=0, plain=None):
    """max |out - plain| / bf16_limit: <= 1 is within the limit, and a
    wrong answer's ratio is its margin over the limit."""
    if plain is None:
        plain = attention_plain(q, k, v, causal=causal, window=window)
    lim = bf16_limit(q, k, v, plain, causal=causal, window=window)
    d = (out.double() - plain.double()).abs()
    return float((d / lim).max())


def flash_tc_emulated(q, k, v, *, causal=True, window=0):
    """Plain-torch emulation of the bf16 kernel's rounding: fp32 scores,
    scaled by fp32(1/sqrt(Dh)) * log2(e) and masked to -1e30 on the
    fragment; an online softmax over the kernel's key tiles with fp32 m
    and l (exp2), l summed from the fp32 p, p rounded to bf16 once for
    P.V, the accumulator rescaled per tile, and acc * (1 / max(l, 1e-30))
    rounded to bf16."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qf = q.float()
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    sl2 = scale * torch.tensor(math.log2(math.e), dtype=torch.float32)
    bk = key_tile(dh)
    n_tiles = -(-sk // bk)
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=dev)
    for t in range(n_tiles):
        ks = slice(t * bk, min((t + 1) * bk, sk))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, ks])
        ok = attend_mask(qpos, torch.arange(ks.start, ks.stop, device=dev),
                         causal, window)
        x = torch.where(ok, s * sl2, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vf[:, :, ks]
        m = m_new
    return (acc * (1.0 / torch.clamp(l, min=1e-30))).to(q.dtype)


# Deliberately wrong answers, each one fault away from attention_plain.

def _scores(q, k):
    """fp32 q.k^T (B,H,Sq,Sk), k repeated over its query heads."""
    rep = q.shape[1] // k.shape[1]
    return torch.einsum("bhqd,bhkd->bhqk", q.float(),
                        k.float().repeat_interleave(rep, dim=1))


def _softmax_pv(s, ok, v):
    """softmax of the fp32 scores ``s`` where ``ok`` (else NEG_INF), times
    v, in v's dtype."""
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
    rep = s.shape[1] // v.shape[1]
    return (p @ v.float().repeat_interleave(rep, dim=1)).to(v.dtype)


def _mask(q, k, causal, window, shift=0):
    return attend_mask(torch.arange(q.shape[2], device=q.device) + shift,
                       torch.arange(k.shape[2], device=q.device), causal,
                       window)


def causal_mask_off_by_one(q, k, v, *, causal=True, window=0):
    """Every row masked as the row after it."""
    return _softmax_pv(_scores(q, k) / math.sqrt(q.shape[-1]),
                       _mask(q, k, causal, window, shift=1), v)


def scale_one_over_dh(q, k, v, *, causal=True, window=0):
    """Scores scaled by 1/Dh instead of 1/sqrt(Dh)."""
    return attention_plain(q.float() / math.sqrt(q.shape[-1]), k.float(),
                           v.float(), causal=causal,
                           window=window).to(q.dtype)


def last_key_tile_dropped(q, k, v, *, causal=True, window=0):
    """The keys of the bf16 kernel's last key tile never seen."""
    bk = key_tile(q.shape[-1])
    last = (k.shape[2] - 1) // bk * bk
    if last == 0:
        return torch.zeros_like(q)
    return attention_plain(q, k[:, :, :last], v[:, :, :last], causal=causal,
                           window=window)


def scores_rounded_before_the_max(q, k, v, *, causal=True, window=0):
    """Scores rounded to bf16 before the softmax."""
    s = _scores(q, k).bfloat16().float() / math.sqrt(q.shape[-1])
    return _softmax_pv(s, _mask(q, k, causal, window), v)


#: the wrong answers the bf16 limit must reject, each by WRONG_MARGIN at
#: some element of the grid: ``fn(q, k, v, causal=, window=)``
WRONG_ANSWERS = {
    "causal mask off by one": causal_mask_off_by_one,
    "scale 1/Dh": scale_one_over_dh,
    "last key tile dropped": last_key_tile_dropped,
    "scores rounded before the row max": scores_rounded_before_the_max,
}
