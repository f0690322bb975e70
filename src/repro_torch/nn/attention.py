"""GQA attention, the port of ``repro/nn/attention.py``: naive, chunked
(flash-style online softmax in plain torch) and the hand-written kernel
path, plus KV-cache decode.  Forward only: the chunked path's custom
backward comes with training.

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
    memory): the forward of the JAX package's ``attention_chunked`` and of
    its custom-VJP ``_flash_attention``.  A loop over key blocks inside a
    loop over query blocks carries (running max, running sum, accumulator).
    With a causal sliding window and equal blocks, a query block visits
    only the last ``ceil(window / k_block) + 1`` key blocks up to its own,
    as ``_flash_core`` does; the blocks it skips are wholly masked."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    q_block = min(q_block, sq)
    k_block = min(k_block, sk)
    nq = -(-sq // q_block)
    nk = -(-sk // k_block)
    scale = 1.0 / math.sqrt(dh)
    window = int(window)
    wb = None
    if causal and window > 0 and q_block == k_block:
        wb = min(math.ceil(window / k_block) + 1, nk)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_block:(qi + 1) * q_block].float()
        rows = q_blk.shape[1]
        q_pos = qi * q_block + torch.arange(rows, device=dev)
        m = torch.full((b, h, rows), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, rows), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, rows, dh), dtype=torch.float32, device=dev)
        kjs = range(nk)
        if wb is not None and wb < nk:
            start = min(max(qi - (wb - 1), 0), nk - wb)
            kjs = range(start, start + wb)
        for kj in kjs:
            k_blk = k[:, kj * k_block:(kj + 1) * k_block].float()
            v_blk = v[:, kj * k_block:(kj + 1) * k_block].float()
            k_pos = kj * k_block + torch.arange(k_blk.shape[1], device=dev)
            logits = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            logits = logits + _mask_bias(q_pos, k_pos, causal, window)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       v_blk)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # (b, rows, h, dh)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    """Dispatch: 'naive' | 'chunked' | 'chunked_ad' | 'pallas' | 'auto'
    ('auto' is chunked above 2048 positions, naive below, as in JAX)."""
    sq, sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "chunked" if max(sq, sk) > 2048 else "naive"
    if impl == "naive":
        return attention_naive(q, k, v, causal=causal, window=window)
    if impl in ("chunked", "chunked_ad"):
        # the two differ in JAX only in their backward
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
