"""The RWKV6 kernel's test cases, shared by ``chip_smoke.py`` and the tests:
the JAX package's kernel test grid, its inputs, and the limits that hold
``rwkv6_chunked_bhsd`` against its plain versions.

Limits, by output dtype name:

- ``RWKV6_TOL``, the kernel against ``rwkv6_plain`` (the same chunked
  algorithm), as (rtol, atol / max|plain|).  fp32: both take every
  exponent from the same sequential fp32 cumsum and the same ``expf``, so
  they differ only in the order of the four products' sums (at most
  dh + 2C = 192 terms an output at dh = C = 64); the reordering bound
  192 * 2**-24 per term, over terms a few times max|out|, gives 2**-14.
  bf16: both round one fp32 result to bf16 once: one ulp, at most 2**-7
  of the output, plus 1e-3 of max|out| near zero.  The final state is
  fp32 in both and is held to the fp32 limit.
- ``RWKV6_REF_TOL``, chunked against the sequential oracle ``rwkv6_ref``:
  the JAX package's own limits (tests/test_kernels.py:114), for the output
  and the state.
- ``RWKV6_BWD_TOL``, the backward kernel against ``rwkv6_plain_vjp``, by
  each gradient's dtype name, the same for dr, dk, dv, dlogw and du.
  fp32: both compute in fp32 from the same inputs but sum in other orders
  and along other paths: the plain version differentiates through the
  cumsum and through ``mid`` (two terms that cancel), the kernel treats
  ``mid`` as a constant and scans W and Z.  The longest sums are dlogw's:
  a reverse and a forward scan over C rows of elements that are each sums
  of about C + dh products, so n = 2C + 2(C + dh) = 384 terms at dh = C =
  64, and its terms reach a few times max|dlogw| (the mid terms cancel);
  n 2**-24 times 4 max|out| is 9e-5, so atol 2**-12 of max|out|, with
  rtol 2**-14 for the elements near the top.  (Measured on the CPU with
  the kernel's source built for the host: at most 7e-6 of max|out|.)  The
  state gradient, carried over every later chunk, is decayed by
  e^{total}: its terms do not grow with S.  bf16 (dr, dk, dv from bf16
  r, k, v): both round one fp32 value to bf16 once, so one bf16 ulp, at
  most 2**-7 of the element, plus 1e-3 of max|out| near zero, the
  forward's bf16 limit.  The wrong gradients of ``RWKV6_BWD_WRONG`` move
  an output by 0.07 to 3 of its max|out|.
"""
from __future__ import annotations

import numpy as np
import torch

RWKV6_TOL = {"float32": (2.0 ** -14, 2.0 ** -14),
             "bfloat16": (2.0 ** -7, 1e-3)}
RWKV6_BWD_TOL = {"float32": (2.0 ** -14, 2.0 ** -12),
                 "bfloat16": (2.0 ** -7, 1e-3)}
RWKV6_REF_TOL = {"float32": dict(rtol=2e-2, atol=1e-3),
                 "bfloat16": dict(rtol=0.15, atol=0.15)}
# (B, H, S, dh, chunk) of the JAX package's grid (tests/test_kernels.py:93-98)
RWKV6_GRID = [(1, 2, 128, 32, 32), (2, 4, 128, 64, 64), (1, 2, 256, 64, 64),
              (1, 1, 64, 128, 16)]


def rwkv6_inputs(b, h, s, dh, gen, *, dtype=torch.float32, layout="bhsd"):
    """randn r/k/v, logw = -exp(0.5 randn), u = 0.1 randn, as the JAX
    package's kernel tests make them, in (B,H,S,dh) or, with
    ``layout="bshd"``, (B,S,H,dh).  ``gen`` is a numpy ``RandomState``
    (CPU tensors, for comparisons with the JAX package) or a
    ``torch.Generator`` (tensors on its device)."""
    if isinstance(gen, np.random.RandomState):
        def randn(*shape):
            return torch.from_numpy(gen.randn(*shape).astype(np.float32))
    else:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=gen.device)
    shape = (b, h, s, dh) if layout == "bhsd" else (b, s, h, dh)
    r, k, v = randn(*shape), randn(*shape), randn(*shape)
    logw = -torch.exp(0.5 * randn(*shape))
    u = 0.1 * randn(h, dh)
    return [t.to(dtype) for t in (r, k, v, logw, u)]



# the wrong gradients that must exceed the backward kernel's limits 10x
RWKV6_BWD_WRONG = ("bonus dropped", "dlogw without the reverse cumsum",
                   "the later chunks' state gradient dropped")


def rwkv6_bwd_ratio(grads, ref) -> float:
    """The worst ``limit_ratio`` of the five gradients (dr, dk, dv,
    dlogw, du) against ``ref``'s, each at ``RWKV6_BWD_TOL`` of its dtype."""
    from repro_torch.kernels.ref import limit_ratio
    worst = 0.0
    for g, r in zip(grads, ref):
        rtol, atol_rel = RWKV6_BWD_TOL[str(g.dtype).split(".")[1]]
        worst = max(worst, limit_ratio(g, r, rtol, atol_rel))
    return worst


def rwkv6_vjp_chunked(r, k, v, logw, u, dy, *, chunk: int = 64,
                      wrong: str | None = None):
    """The backward kernel's algorithm (``csrc/rwkv6_scan_bwd.cuh``) in
    plain torch, chunk by chunk: the states entering every chunk from a
    forward sweep, then a reverse sweep carrying dS, with ``mid`` held
    constant and dlogw from the reverse and forward scans of W and Z.
    Operands as ``ops.rwkv6_chunked_bwd_fp32`` takes them ((B,S,H,dh), u
    (H,dh)); it computes in their common float dtype (upcast to fp32 from
    bf16) and returns (dr, dk, dv, dlogw, du) unpadded.  The tests hold it
    against ``rwkv6_plain_vjp`` in fp64, which checks the derivation; with
    ``wrong`` one of ``RWKV6_BWD_WRONG`` it gives a deliberately wrong
    gradient: the bonus diagonal's terms dropped, dlogw without the
    reverse cumulative sum of W, or no state gradient carried from a chunk
    to the one before it."""
    if wrong not in (None,) + RWKV6_BWD_WRONG:
        raise ValueError(f"unknown wrong answer {wrong!r}")
    ft = torch.promote_types(r.dtype, torch.float32) \
        if r.dtype != torch.bfloat16 else torch.float32
    s = r.shape[1]
    pad = (-s) % chunk

    def bhsd(t):
        t = t.to(ft).transpose(1, 2)
        return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t

    rp, kp, vp, lp, yp = (bhsd(t) for t in (r, k, v, logw, dy))
    uf = u.to(ft)[None, :, None, :]
    b, h, sp, dh = rp.shape
    c = chunk
    lower = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    sl = [slice(i, i + c) for i in range(0, sp, c)]
    S = torch.zeros((b, h, dh, dh), dtype=ft, device=r.device)
    states = []
    for ix in sl:
        states.append(S)
        cum = lp[:, :, ix].cumsum(2)
        total = cum[:, :, -1:]
        k_out = kp[:, :, ix] * torch.exp(total - cum)
        S = torch.exp(total).transpose(-1, -2) * S \
            + k_out.transpose(-1, -2) @ vp[:, :, ix]
    grads = [torch.zeros_like(rp) for _ in range(4)]
    du = torch.zeros((h, dh), dtype=ft, device=r.device)
    dS = torch.zeros_like(S)
    for ix, S0 in zip(reversed(sl), reversed(states)):
        rr, kk, vv, ll, yy = (t[:, :, ix] for t in (rp, kp, vp, lp, yp))
        cum = ll.cumsum(2)
        cp = cum - ll
        total = cum[:, :, -1:]
        mid = cum[:, :, c // 2][:, :, None]
        q_in, q_mid = rr * torch.exp(cp), rr * torch.exp(cp - mid)
        k_mid, k_out = kk * torch.exp(mid - cum), kk * torch.exp(total - cum)
        A = torch.where(lower, q_mid @ k_mid.transpose(-1, -2), 0.0)
        dA = torch.where(lower, yy @ vv.transpose(-1, -2), 0.0)
        bonus = 0.0 if wrong == "bonus dropped" else 1.0
        diag = bonus * (rr * uf * kk).sum(-1, keepdim=True)
        ddiag = bonus * (yy * vv).sum(-1, keepdim=True)
        dq_in = yy @ S0.transpose(-1, -2)
        dq_mid, dk_mid = dA @ k_mid, dA.transpose(-1, -2) @ q_mid
        dk_out = vv @ dS.transpose(-1, -2)
        grads[0][:, :, ix] = dq_in * torch.exp(cp) \
            + dq_mid * torch.exp(cp - mid) + ddiag * uf * kk
        grads[1][:, :, ix] = dk_mid * torch.exp(mid - cum) \
            + dk_out * torch.exp(total - cum) + ddiag * uf * rr
        grads[2][:, :, ix] = k_out @ dS + A.transpose(-1, -2) @ yy \
            + diag * yy
        Y = dk_mid * k_mid
        W = dq_in * q_in + dq_mid * q_mid - Y
        Z = dk_out * k_out
        after = W.flip(2).cumsum(2).flip(2) - W          # sum_{t>s} W[t]
        if wrong == "dlogw without the reverse cumsum":
            after = torch.zeros_like(W)
        before = Z.cumsum(2) - Z                         # sum_{t<s} Z[t]
        eS = torch.exp(total[:, :, 0]) * (S0 * dS).sum(-1)
        grads[3][:, :, ix] = after - Y + before + eS[:, :, None]
        du = du + (ddiag * rr * kk).sum((0, 2))
        if wrong != "the later chunks' state gradient dropped":
            dS = torch.exp(total).transpose(-1, -2) * dS \
                + q_in.transpose(-1, -2) @ yy
    return tuple(g.transpose(1, 2)[:, :s] for g in grads) + (du,)
