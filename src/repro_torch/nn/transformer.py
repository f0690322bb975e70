"""Transformer depth stack, the port of ``repro/nn/transformer.py`` for
attention layers (kind ``'a'``: GQA attention with a per-layer sliding
window + GLU MLP, pre-norms, residuals).

The parameter tree keeps the JAX package's layout: ``{"scan": {...},
"rem": {...}}``, where every ``"scan"`` leaf carries a leading axis over
the repeating pattern *units* of ``stack_plan`` (the layout ``jax.vmap``
over the unit init gives) and ``"rem"`` holds the unrolled remainder
layers.  Decode state has the same shape.  Where JAX scans over units this
port loops in Python, taking a view of each unit's slice.

Not ported yet, each raising ``NotImplementedError``: RWKV6 time-mix
(kind ``'w'``) and RG-LRU (kind ``'r'``) layers and MoE
(ROADMAP Queue 1 item 13; cross-attention comes with the enc-dec family,
which ``models/lm.py`` refuses), and ``checkpointed_scan``, the depth remat of
training (Queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention as attn_mod
from repro_torch.nn.layers import (glu_mlp, glu_mlp_init,
                                   layernorm, layernorm_init, rmsnorm,
                                   rmsnorm_init)

Params = Dict[str, Any]

_TODO = "not ported yet (ROADMAP Queue 1 item 13)"


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype names) -> torch."""
    return getattr(torch, name)


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind in ("w", "r"):
        raise NotImplementedError(f"layer kind {kind!r} (RWKV6 / RG-LRU) "
                                  f"is {_TODO}")
    if kind != "a":
        raise ValueError(kind)
    if cfg.n_experts:
        raise NotImplementedError(f"MoE layers are {_TODO}")


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
    return {
        "norm1": _norm_init(cfg, device, lead),
        "norm2": _norm_init(cfg, device, lead),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.dh, dt,
                                        device=device, lead=lead),
        "mlp": glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device=device,
                            lead=lead),
    }


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                window: int):
    """Returns (x, aux_loss); aux is 0 without MoE."""
    _check_kind(cfg, kind)
    h = _norm(cfg, p["norm1"], x)
    x = x + attn_mod.attention_block(
        p["attn"], h, n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
        window=window, impl=cfg.attn_impl)
    h = _norm(cfg, p["norm2"], x)
    x = x + glu_mlp(p["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
    """The full depth stack, forward (no remat).  Returns (x, aux_sum)."""
    unit, n_units, rem = stack_plan(cfg)
    w_scan, w_rem = _unit_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        up = _index(params["scan"], u)
        for i, kind in enumerate(unit):
            x, a = apply_layer(cfg, kind, up[f"{i}_{kind}"], x, w_scan[u][i])
            aux = aux + a
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
    shape = (*lead, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    cdt = dtype_of(cfg.compute_dtype)
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
    in place: the first S slots of ``state``'s KV cache (views into the
    stack's state, made by ``init_layer_state``) take the prompt's keys
    and values.  Returns (x, state)."""
    _check_kind(cfg, kind)
    s = x.shape[1]
    h = _norm(cfg, p["norm1"], x)
    y, k, v = attn_mod.self_attention_kv(p["attn"], h,
                                         rope_theta=cfg.rope_theta,
                                         window=window, impl=cfg.attn_impl)
    x = x + y
    state["k"][:, :s] = k.to(state["k"].dtype)
    state["v"][:, :s] = v.to(state["v"].dtype)
    h = _norm(cfg, p["norm2"], x)
    x = x + glu_mlp(p["mlp"], h, cfg.act)
    return x, state


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
                 state, pos: int, window: int):
    """One-token decode through a single layer.  x: (B, 1, D).  The KV
    cache in ``state`` is updated in place.  Returns (x, state)."""
    _check_kind(cfg, kind)
    h = _norm(cfg, p["norm1"], x)
    y, _, _ = attn_mod.decode_attention_block(
        p["attn"], h, state["k"], state["v"], pos, n_heads=cfg.n_heads,
        rope_theta=cfg.rope_theta, window=window)
    x = x + y
    h = _norm(cfg, p["norm2"], x)
    x = x + glu_mlp(p["mlp"], h, cfg.act)
    return x, state


def decode_stack(cfg: ModelConfig, params: Params, state, x: torch.Tensor,
                 pos: int):
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
