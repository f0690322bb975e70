"""Causal LM: init / forward / loss / prefill / decode, the port of
``repro/models/lm.py`` for decoder-only stacks of attention layers (kind
``'a'``) and RWKV6 layers (kind ``'w'``).

Batch dict conventions (the JAX package's):
  train:    {"tokens": (B, S) int, "targets": (B, S) int}
  prefill:  {"tokens": (B, S) int}
  decode:   token (B, 1) int, a position (a 0-d int tensor on the state's
            device or a Python int) and the decode state

The encoder-decoder family and the vision/audio frontend stubs raise
``NotImplementedError`` (ROADMAP Queue 1 item 13), as do the layer kinds
``nn/transformer.py`` does not port yet.  ``loss_fn`` gives the value only:
its backward comes with training.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ode_nets import resolve_device
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import transformer as tf
from repro_torch.nn.layers import (embedding, embedding_init, layernorm,
                                   layernorm_init, rmsnorm, rmsnorm_init)

Params = Dict[str, Any]


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError("the encoder-decoder family is not ported "
                                  "yet (ROADMAP Queue 1 item 13)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is not "
                                  "ported yet (ROADMAP Queue 1 item 13)")


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Params:
    """Random weights drawn on ``gen`` (on its own device: a generator on
    the card keeps the draw off the host), placed on ``device`` in the
    config's parameter dtype.  The same tree layout as the JAX package.
    Runs on the card unless ``device="cpu"`` is asked for."""
    _check_cfg(cfg)
    device = resolve_device(device)
    pdt = tf.dtype_of(cfg.param_dtype)
    p: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, pdt,
                                device=device),
        "blocks": tf.init_stack(gen, cfg, device=device),
        "final_norm": rmsnorm_init(cfg.d_model, device=device)
        if cfg.norm == "rmsnorm" else layernorm_init(cfg.d_model,
                                                     device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, pdt,
                                   device=device)
    return p


def _norm(cfg, p, x):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["head"]["table"]
    return torch.matmul(x, table.to(x.dtype).t())


def _embed_tokens(cfg: ModelConfig, params: Params, tokens) -> torch.Tensor:
    return embedding(params["embed"], tokens).to(tf.dtype_of(cfg.compute_dtype))


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Full-sequence forward.  Returns (logits, aux_loss)."""
    _check_cfg(cfg)
    x = _embed_tokens(cfg, params, batch["tokens"])
    x, aux = tf.apply_stack(cfg, params["blocks"], x)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Next-token cross-entropy (+ 0.01 * aux), value only.  Returns (loss,
    metrics).  The logsumexp subtracts the max in the compute dtype and
    sums in fp32, as the JAX package does."""
    logits, aux = forward(cfg, params, batch)
    logits = logits[:, :-1]
    tgt = batch["targets"][:, 1:]
    m = logits.amax(dim=-1, keepdim=True)
    logz = m[..., 0].float() + torch.log(
        torch.exp((logits - m).float()).sum(dim=-1))
    gold = torch.gather(logits, -1, tgt[..., None].long())[..., 0].float()
    ce = (logz - gold).mean()
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device="cuda"):
    """Zeroed decode state for every layer (KV caches; RWKV6 recurrence
    states and token-shift inputs), on the card unless ``device="cpu"``
    is asked for."""
    _check_cfg(cfg)
    return tf.init_stack_state(cfg, batch, max_seq,
                               device=resolve_device(device))


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_seq: int):
    """Run the prompt through the model, filling every layer's decode
    state.  Returns (state, last_logits (B, V))."""
    _check_cfg(cfg)
    x = _embed_tokens(cfg, params, batch["tokens"])
    x, state = tf.prefill_stack(cfg, params["blocks"], x, max_seq)
    x = _norm(cfg, params["final_norm"], x)
    return state, _logits(cfg, params, x[:, -1:])[:, 0]


def decode_step(cfg: ModelConfig, params: Params, state, token: torch.Tensor,
                pos):
    """One decode step.  token: (B, 1) int; pos: a 0-d integer tensor on
    the token's device (the JAX package's scalar int32), or a Python int,
    which becomes such a tensor here, so both forms run the same ops and a
    CUDA graph can capture the step with the position in a buffer.  The
    decode state is updated in place (JAX donates and returns it).
    Returns (logits (B, V), state)."""
    pos = attn_mod.decode_position(pos, token.device)
    x = _embed_tokens(cfg, params, token)
    x, state = tf.decode_stack(cfg, params["blocks"], state, x, pos)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x)[:, 0], state


def expected_flash_calls(cfg: ModelConfig, prefill_waves: int) -> int:
    """Launches of the flash kernel that ``prefill_waves`` prefills make:
    one per attention layer per wave when ``cfg.attn_impl == "pallas"``,
    else 0 (decode attends with plain torch).  The LM counterpart of
    ``core.adjoint.expected_lincomb_calls``."""
    if cfg.attn_impl != "pallas":
        return 0
    return sum(k == "a" for k in cfg.kinds) * int(prefill_waves)


def expected_rwkv6_calls(cfg: ModelConfig, prompt_len: int,
                         prefill_waves: int) -> int:
    """Launches of the RWKV6 kernel that ``prefill_waves`` prefills of
    ``prompt_len`` tokens make: one per RWKV6 layer per wave when the
    prompt is longer than 256 tokens (the chunked form), else 0 (the
    sequential scan; decode is plain torch too).  The counterpart of
    ``expected_flash_calls``."""
    if prompt_len <= 256:
        return 0
    return sum(k == "w" for k in cfg.kinds) * int(prefill_waves)
