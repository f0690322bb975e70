"""Minimal functional NN substrate, the port of ``repro/nn/layers.py``.

Convention: every module is a pair of functions
    init_<mod>(gen, ..., device, lead=()) -> params (dict of tensors)
    <mod>(params, x, ...) -> y
over the JAX package's nested-dict trees and layouts (dense ``w`` is
(d_in, d_out)), so ``repro_torch.convert`` carries a JAX tree across leaf
for leaf.  ``lead`` prepends axes to every leaf: the depth stack draws all
its units at once as one stacked leaf, the layout ``jax.vmap`` over the
unit init gives.  Weights are drawn on the generator's device and then
cast, so a generator on the card keeps a 1e9-parameter init off the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``scale * N(0, 1)`` of ``shape``, drawn in fp32 on ``gen``'s device
    and cast to ``dtype`` on ``device``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(device=device, dtype=dtype)


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def rmsnorm_init(d: int, dtype=torch.float32, *, device="cpu", lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, *, device="cpu", lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype=torch.float32, *,
                   device="cpu"):
    return {"table": normal(gen, (vocab, d), 0.02, dtype, device)}


def embedding(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """The rows of the table at ``ids`` (a gather, as the JAX package's
    ``table[ids]``).  ``F.embedding``'s backward sums the rows' gradients
    in a fixed order; the indexing form's runs in parallel on the CPU and
    gives other bits from run to run."""
    return F.embedding(ids, params["table"])


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
    "tanh": torch.tanh,
}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def glu_mlp_init(gen, d: int, d_ff: int, dtype=torch.float32, *,
                 device="cpu", lead=()):
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": normal(gen, (*lead, d, d_ff), s_in, dtype, device),
        "w_up": normal(gen, (*lead, d, d_ff), s_in, dtype, device),
        "w_down": normal(gen, (*lead, d_ff, d), s_out, dtype, device),
    }


def glu_mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = act_fn(act)(x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_up"].to(x.dtype)
    return (g * u) @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int.  Rotates INTERLEAVED
    pairs (even, odd) as the JAX package does, not the half-split
    ``rotate_half`` of most PyTorch Llama code."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                # (Dh/2,)
    ang = positions[..., None].float() * freqs             # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
