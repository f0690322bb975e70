"""GQA attention, the port of ``repro/nn/attention.py``: naive, chunked
(flash-style online softmax in plain torch) and the hand-written kernel
path, plus KV-cache decode.

Gradients, as in the JAX package: ``impl="chunked"`` is the
recompute-in-backward custom VJP (``_FlashAttention``, the port of
``_flash_attention``: the forward keeps only the output and the row-wise
logsumexp, the backward recomputes each block's probabilities), in plain
torch since the JAX package's is pure jnp; ``"chunked_ad"`` is autograd
through ``attention_chunked``, which keeps every block's probabilities;
``"naive"`` is autograd through the full softmax; ``"pallas"`` has no
gradient on either side (the kernel wrapper refuses autograd, and JAX
cannot differentiate the Pallas kernel).

Layouts are the JAX package's: q (B, Sq, H, Dh), k and v (B, Sk, Hkv, Dh).
Masks: causal, causal + sliding window (``window > 0``), or bidirectional
(``causal=False``).  Windows are Python ints (nothing is traced).
``impl="pallas"`` keeps its name from the JAX package, where it selects
the Pallas TPU kernel; here it selects the Hopper kernel that replaces it
(``kernels/ops.py::flash_attention``), so a config means the same thing on
both sides.  The JAX package's ``_shard_attention_inputs`` has no
counterpart on one device.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.ref import NEG_INF, attend_mask
from repro_torch.nn.layers import apply_rope, normal


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32, *, device="cpu",
                   lead=()):
    s = 1.0 / math.sqrt(d_model)
    so = 1.0 / math.sqrt(n_heads * head_dim)
    return {
        "wq": normal(gen, (*lead, d_model, n_heads, head_dim), s, dtype, device),
        "wk": normal(gen, (*lead, d_model, n_kv_heads, head_dim), s, dtype,
                     device),
        "wv": normal(gen, (*lead, d_model, n_kv_heads, head_dim), s, dtype,
                     device),
        "wo": normal(gen, (*lead, n_heads, head_dim, d_model), so, dtype,
                     device),
    }


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by repeating each kv head."""
    hkv = k.shape[-2]
    if hkv == n_heads:
        return k
    return k.repeat_interleave(n_heads // hkv, dim=-2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive bias (Sq, Sk): 0 where ``attend_mask`` keeps the pair,
    NEG_INF elsewhere.  window: 0 = unlimited; > 0 = sliding window."""
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(attend_mask(q_pos, k_pos, causal, window), zero,
                       NEG_INF)


def attention_naive(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh).  O(Sq*Sk) memory."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    bias = _mask_bias(torch.arange(sq, device=dev),
                      torch.arange(sk, device=dev), causal, int(window))
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      q_block: int = 512, k_block: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch (O(S*block)
    memory), the JAX package's ``attention_chunked``: ``_flash_core`` on
    head-repeated kv, differentiated by autograd (``impl="chunked_ad"``).
    With a causal sliding window and equal blocks, a query block visits
    only the last ``ceil(window / k_block) + 1`` key blocks up to its own;
    the blocks it skips are wholly masked."""
    h = q.shape[2]
    q_block, k_block = min(q_block, q.shape[1]), min(k_block, k.shape[1])
    return _flash_core(q, _repeat_kv(k, h), _repeat_kv(v, h), int(window),
                       causal=causal, q_block=q_block, k_block=k_block,
                       window_static=int(window) if q_block == k_block
                       else None)[0]


# ---------------------------------------------------------------------------
# the chunked path's custom backward (recompute-in-backward), the port of
# the JAX package's ``_flash_fwd`` / ``_flash_bwd``:
#     D   = rowsum(dO * O)
#     P   = exp(S - L)            (recomputed per block)
#     dV += P^T dO ;  dP = dO V^T ;  dS = P * (dP - D)
#     dQ += dS K * scale ;  dK += dS^T Q * scale
# ---------------------------------------------------------------------------

def _win_blocks(window_static, k_block: int, nk: int):
    """Static count of k-blocks a q-block can see under a sliding window
    (None = no static skip)."""
    if window_static is None or window_static <= 0:
        return None
    return min(math.ceil(window_static / k_block) + 1, nk)


def _pad_rows(t: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """Zero-pad ``dim`` of ``t`` up to ``n``."""
    pad = n - t.shape[dim]
    if not pad:
        return t
    spec = [0, 0] * (t.dim() - 1 - dim) + [0, pad]
    return torch.nn.functional.pad(t, spec)


def _k_blocks(qi, q_block, k_block, nk, causal, wb):
    """The k-blocks q-block ``qi`` visits: the static window's last ``wb``
    (the JAX package's clipped start), else every block up to the last one
    a causal mask leaves a key in (the blocks past it are wholly masked, so
    skipping them changes no bit of the online softmax)."""
    if wb is not None and wb < nk:
        start = min(max(qi - (wb - 1), 0), nk - wb)
        return range(start, start + wb)
    if causal:
        return range(min(nk, ((qi + 1) * q_block - 1) // k_block + 1))
    return range(nk)


def _q_blocks(kj, q_block, k_block, nq, causal, wbk):
    """The q-blocks that see k-block ``kj``, the transpose of
    ``_k_blocks``."""
    if wbk is not None and wbk < nq:
        start = min(max(kj, 0), nq - wbk)
        return range(start, start + wbk)
    if causal:
        return range(min(nq, (kj * k_block) // q_block), nq)
    return range(nq)


def _block_bias(qi, kj, q_block, k_block, sk, causal, window, dev):
    q_pos = qi * q_block + torch.arange(q_block, device=dev)
    k_pos = kj * k_block + torch.arange(k_block, device=dev)
    bias = _mask_bias(q_pos, k_pos, causal, window)
    return torch.where((k_pos < sk)[None, :], bias, NEG_INF)


def _flash_core(q, k, v, window: int, *, causal: bool, q_block: int,
                k_block: int, window_static=None):
    """q/k/v: (B, S, H, Dh), kv already head-repeated.  Returns (out
    (B, Sq, H, Dh) in q's dtype, lse (B, H, Sq) fp32), the JAX package's
    ``_flash_core``: S zero-padded to whole blocks, padded keys masked."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    nq, nk = -(-sq // q_block), -(-sk // k_block)
    qp = _pad_rows(q, nq * q_block).float()
    kp = _pad_rows(k, nk * k_block).float()
    vp = _pad_rows(v, nk * k_block).float()
    scale = 1.0 / math.sqrt(dh)
    wb = _win_blocks(window_static, k_block, nk) if causal else None
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        q_blk = qp[:, qi * q_block:(qi + 1) * q_block]
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_block, dh), dtype=torch.float32,
                          device=dev)
        for kj in _k_blocks(qi, q_block, k_block, nk, causal, wb):
            k_blk = kp[:, kj * k_block:(kj + 1) * k_block]
            v_blk = vp[:, kj * k_block:(kj + 1) * k_block]
            logits = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            logits = logits + _block_bias(qi, kj, q_block, k_block, sk,
                                          causal, window, dev)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       v_blk)
            m = m_new
        lsafe = torch.clamp(l, min=1e-30)
        outs.append((acc / lsafe[..., None]).transpose(1, 2))
        lses.append(m + torch.log(lsafe))
    out = torch.cat(outs, dim=1)[:, :sq].to(q.dtype)
    return out, torch.cat(lses, dim=-1)[..., :sq]


def _flash_bwd(q, k, v, out, lse, dout, window: int, causal: bool,
               q_block: int, k_block: int, window_static):
    """The JAX package's ``_flash_bwd``: dq over key blocks inside query
    blocks, then dk/dv over query blocks inside key blocks, each block's
    P = exp(S - L) recomputed.  Returns (dq, dk, dv) in their dtypes."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    nq, nk = -(-sq // q_block), -(-sk // k_block)
    f32 = torch.float32
    qp = _pad_rows(q, nq * q_block).to(f32)
    kp = _pad_rows(k, nk * k_block).to(f32)
    vp = _pad_rows(v, nk * k_block).to(f32)
    dop = _pad_rows(dout.to(f32), nq * q_block)
    op = _pad_rows(out.to(f32), nq * q_block)
    lsep = _pad_rows(lse, nq * q_block, dim=2)
    scale = 1.0 / math.sqrt(dh)
    dvec = torch.einsum("bqhd,bqhd->bhq", dop, op)   # D = rowsum(dO * O)
    wbq = _win_blocks(window_static, k_block, nk) if causal else None
    wbk = _win_blocks(window_static, q_block, nq) if causal else None
    dev = q.device

    def blocks(t, i, n):
        return t[:, i * n:(i + 1) * n]

    def block_p(qi, kj):
        logits = torch.einsum("bqhd,bkhd->bhqk", blocks(qp, qi, q_block),
                              blocks(kp, kj, k_block)) * scale
        logits = logits + _block_bias(qi, kj, q_block, k_block, sk, causal,
                                      window, dev)
        lse_blk = lsep[..., qi * q_block:(qi + 1) * q_block]
        return torch.exp(logits - lse_blk[..., None])      # (b,h,qb,kb)

    def block_ds(qi, kj, p):
        dp = torch.einsum("bqhd,bkhd->bhqk", blocks(dop, qi, q_block),
                          blocks(vp, kj, k_block))
        d_blk = dvec[..., qi * q_block:(qi + 1) * q_block]
        return p * (dp - d_blk[..., None])

    dqs = []
    for qi in range(nq):   # pass 1: dq
        dq_acc = torch.zeros((b, q_block, h, dh), dtype=f32, device=dev)
        for kj in _k_blocks(qi, q_block, k_block, nk, causal, wbq):
            ds = block_ds(qi, kj, block_p(qi, kj))
            dq_acc = dq_acc + torch.einsum(
                "bhqk,bkhd->bqhd", ds, blocks(kp, kj, k_block)) * scale
        dqs.append(dq_acc)
    dks, dvs = [], []
    for kj in range(nk):   # pass 2: dk, dv
        dk_acc = torch.zeros((b, k_block, h, dh), dtype=f32, device=dev)
        dv_acc = torch.zeros((b, k_block, h, dh), dtype=f32, device=dev)
        for qi in _q_blocks(kj, q_block, k_block, nq, causal, wbk):
            p = block_p(qi, kj)
            dv_acc = dv_acc + torch.einsum("bhqk,bqhd->bkhd", p,
                                           blocks(dop, qi, q_block))
            dk_acc = dk_acc + torch.einsum(
                "bhqk,bqhd->bkhd", block_ds(qi, kj, p),
                blocks(qp, qi, q_block)) * scale
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dq = torch.cat(dqs, dim=1)[:, :sq]
    dk = torch.cat(dks, dim=1)[:, :sk]
    dv = torch.cat(dvs, dim=1)[:, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Chunked attention with the recompute-in-backward gradient, the
    JAX package's ``_flash_attention`` custom VJP: the forward saves (q,
    k, v, out, lse), the backward is ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_block, k_block,
                window_static):
        out, lse = _flash_core(q, k, v, window, causal=causal,
                               q_block=q_block, k_block=k_block,
                               window_static=window_static)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (window, causal, q_block, k_block, window_static)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    """Dispatch: 'naive' | 'chunked' | 'chunked_ad' | 'pallas' | 'auto'
    ('auto' is chunked above 2048 positions, naive below, as in JAX)."""
    sq, sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "chunked" if max(sq, sk) > 2048 else "naive"
    if impl == "naive":
        return attention_naive(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        # kv heads repeated before the call, so autograd sums dk/dv over
        # the repeats (the JAX package's order)
        h = q.shape[2]
        return _FlashAttention.apply(q, _repeat_kv(k, h), _repeat_kv(v, h),
                                     int(window), causal, min(512, sq),
                                     min(512, sk), int(window))
    if impl == "chunked_ad":
        return attention_chunked(q, k, v, causal=causal, window=window)
    if impl == "pallas":
        from repro_torch.kernels.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=int(window))
    raise ValueError(impl)


def _project(x, w):
    """(B, S, D) x (D, H, Dh) -> (B, S, H, Dh)."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _out_project(o, w):
    """(B, S, H, Dh) x (H, Dh, D) -> (B, S, D)."""
    return torch.einsum("bshk,hkd->bsd", o, w.to(o.dtype))


def _qkv(params, x: torch.Tensor, pos: torch.Tensor, rope_theta: float):
    """Projections of x (B, S, D) to q, k, v, with RoPE at ``pos``
    ((1, S) or (B, 1) positions) on q and k."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    return q, k, v


def self_attention_kv(params, x: torch.Tensor, *, rope_theta: float,
                      window: int = 0, impl: str = "auto"):
    """Causal self-attention at positions 0..S-1.  Returns (out, k, v): the
    output projection and the keys and values a prefill caches."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(params, x, pos, rope_theta)
    o = attention(q, k, v, causal=True, window=window, impl=impl)
    return _out_project(o, params["wo"]), k, v


def attention_block(params, x: torch.Tensor, *, n_heads: int,
                    rope_theta: float, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Causal self-attention: projections, RoPE at positions 0..S-1,
    attention, output projection.  (Cross-attention comes with the
    enc-dec family.)"""
    return self_attention_kv(params, x, rope_theta=rope_theta, window=window,
                             impl=impl)[0]


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def decode_position(pos, device) -> torch.Tensor:
    """A decode position as the 0-d int64 tensor on ``device`` that the
    decode path takes: an integer tensor is checked and widened, a Python
    int is filled in on the device (a kernel, not a copy from the host)."""
    if not torch.is_tensor(pos):
        return torch.full((), int(pos), dtype=torch.long, device=device)
    if pos.dim() != 0 or pos.dtype.is_floating_point \
            or pos.dtype == torch.bool or pos.device != torch.device(device):
        raise ValueError(
            f"a decode position must be a 0-d integer tensor on {device}, "
            f"got {pos.device}/{pos.dtype}/{tuple(pos.shape)}")
    return pos.long()


def decode_attention_block(params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos, *, n_heads: int,
                           rope_theta: float, window: int = 0):
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, S_max, Hkv, Dh);
    pos: the current position (``decode_position``: a 0-d integer tensor
    on x's device, or a Python int; nothing about a tensor position is
    read on the host, so a CUDA graph can capture the step).
    Writes the new key and value into the caches IN PLACE at ``pos``
    (``index_copy_``; the JAX package returns updated caches from
    ``dynamic_update_slice`` on a donated state; here the caller's state
    tensors are that state).  Returns (out, cache_k, cache_v).  Attends
    over all S_max slots with a mask, as JAX does; the kv heads are grouped
    rather than repeated, which takes the same dot products.

    Under ``torch.use_deterministic_algorithms(True)`` PyTorch routes
    ``index_copy_`` on the card through an indexed write that checks the
    index range on the host, which a CUDA graph capture refuses."""
    pos = decode_position(pos, x.device)
    b = x.shape[0]
    q, k_new, v_new = _qkv(params, x, pos.expand(b, 1), rope_theta)
    slot = pos.reshape(1)
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    _, s_max, hkv, dh = cache_k.shape
    h = q.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, dh)               # (B,G,R,Dh)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg, cache_k.float())
    logits = logits / math.sqrt(dh)
    ok = attend_mask(slot, torch.arange(s_max, device=x.device), True,
                     window)[0]
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", probs, cache_v.float())
    o = o.reshape(b, 1, h, dh).to(x.dtype)
    return _out_project(o, params["wo"]), cache_k, cache_v
