"""Transformer depth stack, the port of ``repro/nn/transformer.py`` for
attention layers (kind ``'a'``: GQA attention with a per-layer sliding
window + GLU MLP) and RWKV6 layers (kind ``'w'``: RWKV6 time-mix + RWKV
channel-mix), with pre-norms and residuals.

The parameter tree keeps the JAX package's layout: ``{"scan": {...},
"rem": {...}}``, where every ``"scan"`` leaf carries a leading axis over
the repeating pattern *units* of ``stack_plan`` (the layout ``jax.vmap``
over the unit init gives) and ``"rem"`` holds the unrolled remainder
layers.  Decode state has the same shape.  Where JAX scans over units this
port loops in Python, taking a view of each unit's slice.

A ``'w'`` layer takes the chunked time-mix (the RWKV6 kernel) when the
sequence is longer than 256 tokens and the sequential scan otherwise, the
JAX package's rule; its decode state is the fp32 recurrence state ``S``
and the last normed inputs of the two token shifts, ``tm_prev`` and
``cm_prev``.

The training pass (``apply_stack``) runs the units through
``core/depth_ode.py::checkpointed_scan`` with ``cfg.remat`` and
``cfg.ncheck`` (the depth remat policy), carrying (x, aux) as the JAX
package does, and unrolls the remainder layers; prefill and decode run
no remat.

An ``'a'`` layer of a config with ``n_experts`` takes the MoE block
(``nn/moe.py``) for its MLP, as the JAX package does: training and the
forward at ``cfg.capacity_factor`` (its aux loss summed over the stack),
prefill and decode dropless (``max(cf, E)``), prefill on the routed rows
only and decode in static slots.

Not ported yet, raising ``NotImplementedError``: RG-LRU layers (kind
``'r'``; ROADMAP Queue 1 item 13; cross-attention comes with the enc-dec
family, which ``models/lm.py`` refuses).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.depth_ode import checkpointed_scan
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm as ssm_mod
from repro_torch.nn.layers import (glu_mlp, glu_mlp_init,
                                   layernorm, layernorm_init, rmsnorm,
                                   rmsnorm_init)

Params = Dict[str, Any]

_TODO = "not ported yet (ROADMAP Queue 1 item 13)"


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype names) -> torch."""
    return getattr(torch, name)


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind == "r":
        raise NotImplementedError(f"layer kind 'r' (RG-LRU) is {_TODO}")
    if kind not in ("a", "w"):
        raise ValueError(kind)


def _mlp(cfg: ModelConfig, p: Params, h: torch.Tensor, *,
         inference: bool = False, dispatch: str = "slots"):
    """An ``'a'`` layer's channel mix: the GLU MLP, or the MoE block
    (dropless at inference, the reference's ``max(cf, E)``).  Returns
    (y, aux)."""
    if not cfg.n_experts:
        return glu_mlp(p["mlp"], h, cfg.act), None
    cf = max(cfg.capacity_factor, float(cfg.n_experts)) if inference \
        else cfg.capacity_factor
    return moe_mod.moe_block(p["moe"], h, n_experts=cfg.n_experts,
                             top_k=cfg.top_k, act=cfg.act,
                             capacity_factor=cf, dispatch=dispatch)


def _rwkv_layer(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """A ``'w'`` layer's full-sequence pass.  The time-mix is chunked (the
    kernel) above 256 tokens and the sequential scan at or below, the JAX
    package's rule.  Returns (x, S, h, h2): the recurrence state after the
    sequence and the normed inputs of the time-mix and channel-mix."""
    h = _norm(cfg, p["norm1"], x)
    mix = ssm_mod.rwkv6_mix_chunked if x.shape[1] > 256 \
        else ssm_mod.rwkv6_mix_scan
    y, S = mix(p["tmix"], h, cfg.n_heads)
    x = x + y
    h2 = _norm(cfg, p["norm2"], x)
    return x + ssm_mod.rwkv_channel_mix(p["cmix"], h2), S, h, h2


def _norm_init(cfg: ModelConfig, device, lead=()):
    return layernorm_init(cfg.d_model, device=device, lead=lead) \
        if cfg.norm == "layernorm" \
        else rmsnorm_init(cfg.d_model, device=device, lead=lead)


def _norm(cfg: ModelConfig, p, x):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


def _index(tree, u: int):
    """The ``u``-th unit of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


# ---------------------------------------------------------------------------
# per-layer init and full-sequence apply
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, kind: str, *, device="cpu",
               lead=()) -> Params:
    _check_kind(cfg, kind)
    dt = dtype_of(cfg.param_dtype)
    p = {"norm1": _norm_init(cfg, device, lead),
         "norm2": _norm_init(cfg, device, lead)}
    if kind == "w":
        p["tmix"] = ssm_mod.init_rwkv6(gen, cfg.d_model, cfg.n_heads, dt,
                                       device=device, lead=lead)
        p["cmix"] = ssm_mod.init_rwkv_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                                  dt, device=device,
                                                  lead=lead)
        return p
    p["attn"] = attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.dh, dt,
                                        device=device, lead=lead)
    if cfg.n_experts:
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, dt, device=device,
                                    lead=lead)
    else:
        p["mlp"] = glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt,
                                device=device, lead=lead)
    return p


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                window: int):
    """Returns (x, aux_loss); aux is 0 without MoE."""
    _check_kind(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "w":
        return _rwkv_layer(cfg, p, x)[0], aux
    h = _norm(cfg, p["norm1"], x)
    x = x + attn_mod.attention_block(
        p["attn"], h, n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
        window=window, impl=cfg.attn_impl)
    h = _norm(cfg, p["norm2"], x)
    y, moe_aux = _mlp(cfg, p, h)
    return x + y, aux if moe_aux is None else moe_aux


# ---------------------------------------------------------------------------
# stack grouping: (scan units, unrolled remainder)
# ---------------------------------------------------------------------------

def stack_plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """Returns (unit_kinds, n_units, remainder_kinds), as the JAX package:
    the shortest repeating pattern of (kind, window) pairs that covers
    every distinct layer is the unit; the remainder layers are unrolled."""
    kinds = cfg.kinds
    sig = tuple(zip(kinds, cfg.win))
    uniq = tuple(sorted(set(sig)))
    if len(uniq) == 1:
        return (kinds[0],), len(kinds), ()
    for ulen in range(2, len(sig) + 1):
        unit = sig[:ulen]
        n_units = len(sig) // ulen
        if unit * n_units == sig[:ulen * n_units] \
                and len(set(unit)) == len(uniq):
            rem = kinds[ulen * n_units:]
            return tuple(k for k, _ in unit), n_units, rem
    return tuple(kinds), 1, ()


def _unit_windows(cfg: ModelConfig):
    """(per-unit window tuples, remainder windows), all Python ints."""
    unit, n_units, rem = stack_plan(cfg)
    ulen = len(unit)
    rows = [tuple(cfg.win[u * ulen:(u + 1) * ulen]) for u in range(n_units)]
    return rows, tuple(cfg.win[ulen * n_units:])


def init_stack(gen, cfg: ModelConfig, *, device="cpu") -> Params:
    unit, n_units, rem = stack_plan(cfg)
    stacked = {f"{i}_{kind}": init_layer(gen, cfg, kind, device=device,
                                         lead=(n_units,))
               for i, kind in enumerate(unit)}
    rem_p = {f"rem{i}_{kind}": init_layer(gen, cfg, kind, device=device)
             for i, kind in enumerate(rem)}
    return {"scan": stacked, "rem": rem_p}


def apply_stack(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """The full depth stack with the configured depth remat policy
    (``cfg.remat``, ``cfg.ncheck``) over the units; the remainder layers
    unrolled.  Returns (x, aux_sum)."""
    unit, n_units, rem = stack_plan(cfg)
    w_scan, w_rem = _unit_windows(cfg)
    # the units' windows ride along the scan as a host tensor, as the JAX
    # package scans an int array beside the stacked parameters
    wins = torch.tensor(w_scan, dtype=torch.long).reshape(n_units, len(unit))

    def unit_fn(carry, scanned):
        xx, aux = carry
        up, w = scanned
        for i, (kind, wi) in enumerate(zip(unit, w.tolist())):
            xx, a = apply_layer(cfg, kind, up[f"{i}_{kind}"], xx, wi)
            aux = aux + a
        return xx, aux

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = checkpointed_scan(unit_fn, (x, aux0), (params["scan"], wins),
                               n_units, remat=cfg.remat, ncheck=cfg.ncheck)
    for i, kind in enumerate(rem):
        x, a = apply_layer(cfg, kind, params["rem"][f"rem{i}_{kind}"], x,
                           w_rem[i])
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# prefill (full prompt -> decode state)
# ---------------------------------------------------------------------------

def init_layer_state(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     *, device="cpu", lead=()):
    _check_kind(cfg, kind)
    cdt = dtype_of(cfg.compute_dtype)
    if kind == "w":
        prev = (*lead, batch, 1, cfg.d_model)
        return {"S": torch.zeros((*lead, batch, cfg.n_heads, cfg.dh, cfg.dh),
                                 dtype=torch.float32, device=device),
                "tm_prev": torch.zeros(prev, dtype=cdt, device=device),
                "cm_prev": torch.zeros(prev, dtype=cdt, device=device)}
    shape = (*lead, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def init_stack_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                     device="cpu"):
    unit, n_units, rem = stack_plan(cfg)
    scan_state = {f"{i}_{kind}": init_layer_state(
        cfg, kind, batch, max_seq, device=device, lead=(n_units,))
        for i, kind in enumerate(unit)}
    rem_state = {f"rem{i}_{kind}": init_layer_state(
        cfg, kind, batch, max_seq, device=device)
        for i, kind in enumerate(rem)}
    return {"scan": scan_state, "rem": rem_state}


def prefill_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                  window: int, state):
    """Full-sequence layer pass that also fills the layer's decode state
    in place (``state`` holds views into the stack's state, made by
    ``init_layer_state``): for ``'a'`` the first S slots of the KV cache
    take the prompt's keys and values; for ``'w'`` ``S`` takes the
    recurrence state after the prompt and ``tm_prev`` / ``cm_prev`` the
    last normed inputs of the time-mix and channel-mix.  Returns (x,
    state)."""
    _check_kind(cfg, kind)
    if kind == "w":
        x, S, h, h2 = _rwkv_layer(cfg, p, x)
        state["S"].copy_(S)
        state["tm_prev"].copy_(h[:, -1:])
        state["cm_prev"].copy_(h2[:, -1:])
        return x, state
    s = x.shape[1]
    h = _norm(cfg, p["norm1"], x)
    y, k, v = attn_mod.self_attention_kv(p["attn"], h,
                                         rope_theta=cfg.rope_theta,
                                         window=window, impl=cfg.attn_impl)
    x = x + y
    state["k"][:, :s] = k.to(state["k"].dtype)
    state["v"][:, :s] = v.to(state["v"].dtype)
    h = _norm(cfg, p["norm2"], x)
    y, _ = _mlp(cfg, p, h, inference=True, dispatch="sorted")
    return x + y, state


def prefill_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  max_seq: int):
    """Inference pass (no remat) producing hidden states + the decode state
    of every layer.  Returns (x, state)."""
    unit, n_units, rem = stack_plan(cfg)
    w_scan, w_rem = _unit_windows(cfg)
    state = init_stack_state(cfg, x.shape[0], max_seq, device=x.device)
    for u in range(n_units):
        up = _index(params["scan"], u)
        ust = _index(state["scan"], u)
        for i, kind in enumerate(unit):
            key = f"{i}_{kind}"
            x, _ = prefill_layer(cfg, kind, up[key], x, w_scan[u][i],
                                 ust[key])
    for i, kind in enumerate(rem):
        key = f"rem{i}_{kind}"
        x, _ = prefill_layer(cfg, kind, params["rem"][key], x, w_rem[i],
                             state["rem"][key])
    return x, state


# ---------------------------------------------------------------------------
# decode (single token, stateful)
# ---------------------------------------------------------------------------

def decode_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 state, pos: torch.Tensor, window: int):
    """One-token decode through a single layer.  x: (B, 1, D); pos: a
    0-d int64 tensor on x's device (``models/lm.py::decode_step``).  The
    layer's state (KV cache, or RWKV6 ``S``, ``tm_prev`` and ``cm_prev``)
    is updated in place.  Returns (x, state)."""
    _check_kind(cfg, kind)
    h = _norm(cfg, p["norm1"], x)
    if kind == "w":
        y, S = ssm_mod.rwkv6_mix_decode(p["tmix"], state["tm_prev"], h,
                                        state["S"], cfg.n_heads)
        x = x + y
        h2 = _norm(cfg, p["norm2"], x)
        hh2 = torch.cat([state["cm_prev"].to(h2.dtype), h2], dim=1)
        x = x + ssm_mod.rwkv_channel_mix(p["cmix"], hh2)[:, 1:]
        state["S"].copy_(S)
        state["tm_prev"].copy_(h)
        state["cm_prev"].copy_(h2)
        return x, state
    y, _, _ = attn_mod.decode_attention_block(
        p["attn"], h, state["k"], state["v"], pos, n_heads=cfg.n_heads,
        rope_theta=cfg.rope_theta, window=window)
    x = x + y
    h = _norm(cfg, p["norm2"], x)
    y, _ = _mlp(cfg, p, h, inference=True)
    return x + y, state


def decode_stack(cfg: ModelConfig, params: Params, state, x: torch.Tensor,
                 pos: torch.Tensor):
    unit, n_units, rem = stack_plan(cfg)
    w_scan, w_rem = _unit_windows(cfg)
    for u in range(n_units):
        up = _index(params["scan"], u)
        ust = _index(state["scan"], u)
        for i, kind in enumerate(unit):
            key = f"{i}_{kind}"
            x, _ = decode_layer(cfg, kind, up[key], x, ust[key], pos,
                                w_scan[u][i])
    for i, kind in enumerate(rem):
        key = f"rem{i}_{kind}"
        x, _ = decode_layer(cfg, kind, params["rem"][key], x,
                            state["rem"][key], pos, w_rem[i])
    return x, state
