"""Plain PyTorch versions of the port's kernels.

The wrappers in ``kernels/ops.py`` use these for tensors on the CPU; on
the card they are the oracle the kernels are held against: bitwise for
``fused_lincomb``, within a stated tolerance for the flash and RWKV6
kernels, whose sums run in another order.  ``rwkv6_ref`` is the
sequential RWKV6 oracle (the JAX package's ``rwkv6_ref``);
``rwkv6_plain`` is the chunked algorithm of the TPU kernel and the RWKV6
kernel's plain version.  ``limit_ratio`` says how far a kernel's output is
from its oracle, in units of a stated limit."""
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


def rwkv6_ref(r, k, v, logw, u):
    """Sequential RWKV6 recurrence, the port of the JAX package's
    ``ref.rwkv6_ref``.  r/k/v/logw: (B,H,S,dh); u: (H,dh).  Per step, from
    a zero fp32 state S (dk, dv):

        o_t = r_t S + (r_t . (u * k_t)) v_t,  S <- exp(logw_t) S + k_t (x) v_t

    Returns (out in r's dtype, final state fp32 (B,H,dh,dh))."""
    b, h, s, dh = r.shape
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None]
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        ot = torch.einsum("bhk,bhkv->bhv", rt, S) \
            + (rt * (uf * kt)).sum(-1, keepdim=True) * vt
        S = torch.exp(lwf[:, :, t])[..., None] * S \
            + torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(ot)
    return torch.stack(outs, 2).to(r.dtype), S


def rwkv6_chunk_step(S, r, k, v, lw, u):
    """One chunk of the chunked RWKV6 form, the arithmetic of the TPU
    kernel's ``_rwkv6_kernel`` body.  S: (B,H,dk,dv) fp32 state entering
    the chunk; r/k/v/lw: (B,H,C,dh) fp32; u: (H,dh) fp32.  With the
    inclusive per-channel cumsum ``cum`` of lw, ``total = cum[C-1]`` and the
    midpoint renormaliser ``mid = cum[C // 2]``:

        o = (r e^{cum-lw}) S + tril_{-1}[(r e^{cum-lw-mid})(k e^{mid-cum})^T] v
            + (sum_d r u k) v
        S' = e^{total}^T * S + (k e^{total-cum})^T v

    Returns (o (B,H,C,dh) fp32, S')."""
    c = r.shape[2]
    cum = lw.cumsum(2)
    cum_prev = cum - lw
    total = cum[:, :, -1:]
    mid = cum[:, :, c // 2][:, :, None]
    q_in = r * torch.exp(cum_prev)
    q_mid = r * torch.exp(cum_prev - mid)
    k_mid = k * torch.exp(mid - cum)
    k_out = k * torch.exp(total - cum)
    o_inter = q_in @ S
    lower = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(lower, q_mid @ k_mid.transpose(-1, -2), 0.0)
    o_intra = att @ v
    o_diag = (r * u[None, :, None, :] * k).sum(-1, keepdim=True) * v
    S = torch.exp(total).transpose(-1, -2) * S + k_out.transpose(-1, -2) @ v
    return o_inter + o_intra + o_diag, S


def rwkv6_plain(r, k, v, logw, u, *, chunk: int = 64, state=None):
    """Plain version of ``ops.rwkv6_chunked_bhsd``: ``rwkv6_chunk_step``
    over the chunks in order.  r/k/v/logw: (B,H,S,dh) with S a multiple of
    ``chunk``; u: (H,dh).  Every operand is upcast to fp32, as the TPU
    kernel does; the state starts from zero, or from ``state`` (B,H,dh,dh)
    where a caller carries one (the kernel does not).  Returns (out in
    r's dtype, final state fp32)."""
    b, h, s, dh = r.shape
    if s % chunk:
        raise ValueError(f"rwkv6_plain: S={s} is not a multiple of the "
                         f"chunk {chunk}")
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    outs = []
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        o, S = rwkv6_chunk_step(S, rf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                                lwf[:, :, sl], uf)
        outs.append(o)
    return torch.cat(outs, 2).to(r.dtype), S


def limit_ratio(out, ref, rtol, atol_rel=0.0, atol=0.0):
    """max |out - ref| / (atol + atol_rel * max|ref| + rtol * |ref|): <= 1
    is within the limit, and a wrong answer's ratio is its margin over
    the limit."""
    o, r = out.double(), ref.double()
    bound = atol + atol_rel * float(r.abs().max()) + rtol * r.abs()
    return float(((o - r).abs() / bound.clamp_min(1e-300)).max())
