"""RWKV6 (Finch) time-mix and channel-mix, the port of the RWKV6 half of
``repro/nn/ssm.py``.

RWKV6 recurrence (per head, dk key channels, dv value channels):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          (data-dependent decay w_t)
    o_t = r_t @ S_{t-1} + (r_t . (u . k_t)) v_t     (u: per-channel bonus)

in three forms, as in the JAX package: the sequential scan
(``rwkv6_mix_scan``, the oracle), the chunked form (``rwkv6_mix_chunked``:
intra-chunk product-form attention with a per-channel midpoint
renormalisation plus inter-chunk state propagation) and one-token decode
(``rwkv6_mix_decode``).

Routing.  The JAX package's chunked form is its own jnp ``chunk_step``
scan; the port puts the Hopper kernel that replaces the TPU kernel
``rwkv6_chunked_bhsd`` in its place, which computes the same function:

- ``rwkv6_mix_chunked`` with ``state=None`` calls
  ``kernels.ops.rwkv6_chunked_fp32`` with ``c = min(chunk, S)`` on the
  projections as they come: r, k and v in x's dtype, logw fp32, all
  (B,S,H,dh) views, and gets fp32 (B,S,H,dh) back.  For CUDA tensors the
  kernel reads them in place (bf16 upcast on load, as the JAX ``resh``
  casts to fp32; the ragged last chunk masked); for CPU tensors it is
  ``rwkv6_plain`` on upcast, zero-padded (B,H,S',dh) copies.  Both are
  the JAX ``chunk_step`` scan from a zero state: the same c, the same zero
  padding, the same ``mid = cum[c // 2]``.  On the card, the in-place
  read gives bit for bit what the kernel gives on the upcast, padded
  copies.
- Gradients: the chunked form with ``state=None`` is a
  ``torch.autograd.Function`` (``_Rwkv6Chunked``) whose forward is
  ``rwkv6_chunked_fp32`` and whose backward is
  ``ops.rwkv6_chunked_bwd_fp32``, the RWKV6 backward kernel on the card
  (``rwkv6_plain_vjp`` for CPU tensors): the same function the JAX
  package's autodiff of ``chunk_step`` computes.  The final state it
  returns carries no gradient (training drops it); a gradient arriving
  for it raises.  ``rwkv6_mix_scan`` is plain torch under autograd.
- Given a ``state`` it runs ``rwkv6_plain`` from that state on the CPU and
  raises on the card: the kernel starts from a zero state, as the TPU
  kernel does.  No caller in the JAX package passes one.
- ``rwkv6_mix_scan`` and ``rwkv6_mix_decode`` are plain torch, as in JAX.
- The tensors' device chooses the route; no config field, environment
  variable or flag does.  ``nn/transformer.py`` takes the chunked form
  for S > 256 and the scan otherwise, the JAX package's rule.

Dtypes follow the JAX package: the token-shift mix and the projections
run in x's dtype, the decay ``logw = -exp(w_base + dd)`` and the
recurrence in fp32, the per-head group norm in fp32 (population
variance), and the result is cast back to x's dtype before the silu gate
and the output projection.  ``w_base``, ``u_bonus``, ``mix`` and
``ln_scale`` are fp32 parameters whatever the parameter dtype.

RG-LRU (recurrentgemma) is not ported yet: its entry points raise
``NotImplementedError`` (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_plain
from repro_torch.nn.layers import normal

_RGLRU_TODO = "RG-LRU is not ported yet (ROADMAP Queue 1 item 13)"


# ---------------------------------------------------------------------------
# RWKV6 time-mix
# ---------------------------------------------------------------------------

def init_rwkv6(gen, d_model: int, n_heads: int, dtype=torch.float32, *,
               device="cpu", lead=()):
    dh = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    f32 = torch.float32

    def proj():
        return normal(gen, (*lead, d_model, d_model), s, dtype, device)

    return {
        "w_r": proj(), "w_k": proj(), "w_v": proj(), "w_g": proj(),
        "w_o": proj(),
        # data-dependent decay: w_t = exp(-exp(w_base + x @ w_lora))
        "w_base": torch.full((*lead, d_model), -0.5, dtype=f32,
                             device=device),
        "w_lora": normal(gen, (*lead, d_model, d_model), s * 0.1, dtype,
                         device),
        "u_bonus": normal(gen, (*lead, n_heads, dh), 0.1, f32, device),
        "mix": torch.full((*lead, 5, d_model), 0.5, dtype=f32,
                          device=device),  # r, k, v, g, w shifts
        "ln_scale": torch.ones((*lead, n_heads, dh), dtype=f32,
                               device=device),
    }


def _token_shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_projections(params, x: torch.Tensor, n_heads: int):
    """Shared projection code: returns r, k, v (B,S,H,dh) and g (B,S,D) in
    x's dtype, and logw (B,S,H,dh) fp32."""
    b, s, d = x.shape
    dh = d // n_heads
    dx = _token_shift(x) - x
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + dx * mix[i] for i in range(5))
    r = (xr @ params["w_r"].to(x.dtype)).reshape(b, s, n_heads, dh)
    k = (xk @ params["w_k"].to(x.dtype)).reshape(b, s, n_heads, dh)
    v = (xv @ params["w_v"].to(x.dtype)).reshape(b, s, n_heads, dh)
    g = xg @ params["w_g"].to(x.dtype)
    # data-dependent decay (Finch): log w_t in (-inf, 0)
    dd = (xw @ params["w_lora"].to(x.dtype)).float()
    logw = -torch.exp(params["w_base"] + dd)            # (B,S,D) fp32, < 0
    return r, k, v, g, logw.reshape(b, s, n_heads, dh)


def _rwkv6_step(S, rt, kt, vt, lw, u):
    """One recurrence step, fp32.  S: (B,H,dk,dv); rt/kt/vt/lw: (B,H,dh).
    Returns (o_t (B,H,dh), S_t)."""
    ot = torch.einsum("bhk,bhkv->bhv", rt, S) \
        + (rt * (u[None] * kt)).sum(-1, keepdim=True) * vt
    S = torch.exp(lw)[..., None] * S + torch.einsum("bhk,bhv->bhkv", kt, vt)
    return ot, S


def rwkv6_mix_scan(params, x: torch.Tensor, n_heads: int,
                   state: torch.Tensor | None = None):
    """Sequential oracle.  x: (B,S,D).  state: (B,H,dk,dv) or None.
    Returns (y, new_state)."""
    b, s, d = x.shape
    dh = d // n_heads
    r, k, v, g, logw = rwkv6_projections(params, x, n_heads)
    u = params["u_bonus"]
    if state is None:
        state = torch.zeros((b, n_heads, dh, dh), dtype=torch.float32,
                            device=x.device)
    r, k, v = r.float(), k.float(), v.float()
    outs = []
    for t in range(s):
        ot, state = _rwkv6_step(state, r[:, t], k[:, t], v[:, t],
                                logw[:, t], u)
        outs.append(ot)
    y = torch.stack(outs, 1)                            # (B,S,H,dh)
    return _rwkv_out(params, y, g, x.dtype, b, s, d), state


def _rwkv_out(params, y, g, dtype, b, s, d):
    # per-head group norm (population variance, as jnp.var), silu gate,
    # output projection
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mu).mean(dim=-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 1e-5) * params["ln_scale"][None, None]
    y = y.reshape(b, s, d).to(dtype) * F.silu(g)
    return y @ params["w_o"].to(dtype)


class _Rwkv6Chunked(torch.autograd.Function):
    """The chunked recurrence from a zero state: forward
    ``ops.rwkv6_chunked_fp32``, backward ``ops.rwkv6_chunked_bwd_fp32``
    (the output's gradient only: the final state gets none)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        y, state = ops.rwkv6_chunked_fp32(r, k, v, logw, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "rwkv6_mix_chunked: the final state carries no gradient "
                "(training drops it, as the JAX package's stack does)")
        if dy is None:
            return (None,) * 6
        grads = ops.rwkv6_chunked_bwd_fp32(*ctx.saved_tensors, dy,
                                           chunk=ctx.chunk)
        return (*grads, None)


def rwkv6_mix_chunked(params, x: torch.Tensor, n_heads: int,
                      state: torch.Tensor | None = None, chunk: int = 64):
    """Chunked-parallel form (matches the scan oracle; the routing rule is
    in the module docstring).  Returns (y, new_state)."""
    b, s, d = x.shape
    r, k, v, g, logw = rwkv6_projections(params, x, n_heads)
    u = params["u_bonus"]
    c = min(chunk, s)
    if state is None:
        y, state = _Rwkv6Chunked.apply(r, k, v, logw, u, c)
    elif x.device.type == "cpu":
        y, state = rwkv6_plain(*(ops.bhsd_padded(t.float(), c)
                                 for t in (r, k, v, logw)),
                               u, chunk=c, state=state)
        y = y.transpose(1, 2)[:, :s]
    else:
        raise NotImplementedError(
            "rwkv6_mix_chunked: the RWKV6 kernel starts from a zero state, "
            "as the TPU kernel does; a carried state runs only on the CPU")
    return _rwkv_out(params, y, g, x.dtype, b, s, d), state


def rwkv6_mix_decode(params, h_prev: torch.Tensor, h_cur: torch.Tensor,
                     state: torch.Tensor, n_heads: int):
    """Single-token decode.  h_prev/h_cur: (B,1,D) *normed* inputs of the
    previous and current token (prev feeds the token-shift mixing only);
    state: (B,H,dk,dv).  Both positions are projected, as in the JAX
    package.  Returns (y (B,1,D), new_state)."""
    b, _, d = h_cur.shape
    hh = torch.cat([h_prev.to(h_cur.dtype), h_cur], dim=1)
    r, k, v, g, logw = rwkv6_projections(params, hh, n_heads)
    # only the current position (index 1); its token-shift saw h_prev
    ot, state = _rwkv6_step(state, r[:, 1].float(), k[:, 1].float(),
                            v[:, 1].float(), logw[:, 1], params["u_bonus"])
    y = _rwkv_out(params, ot[:, None], g[:, 1:], h_cur.dtype, b, 1, d)
    return y, state


def init_rwkv_channel_mix(gen, d_model: int, d_ff: int, dtype=torch.float32,
                          *, device="cpu", lead=()):
    return {
        "w_in": normal(gen, (*lead, d_model, d_ff), 1.0 / math.sqrt(d_model),
                       dtype, device),
        "w_out": normal(gen, (*lead, d_ff, d_model), 1.0 / math.sqrt(d_ff),
                        dtype, device),
        "mix": torch.full((*lead, d_model), 0.5, dtype=torch.float32,
                          device=device),
    }


def rwkv_channel_mix(params, x: torch.Tensor):
    xk = x + (_token_shift(x) - x) * params["mix"].to(x.dtype)
    h = torch.square(F.relu(xk @ params["w_in"].to(x.dtype)))
    return h @ params["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma): not ported yet
# ---------------------------------------------------------------------------

def init_rglru_block(*args, **kwargs):
    raise NotImplementedError(_RGLRU_TODO)


def rglru(*args, **kwargs):
    raise NotImplementedError(_RGLRU_TODO)


def rglru_block(*args, **kwargs):
    raise NotImplementedError(_RGLRU_TODO)
