"""Architecture config schema + input-shape cells (a copy of the JAX
package's ``repro/configs/base.py``: shapes only, no weights).

Every assigned architecture is a frozen ``ModelConfig``; the four assigned
input shapes are ``ShapeCell``s.  ``layer_kinds`` describes the per-layer
pattern ('a' attention, 'r' RG-LRU recurrent, 'w' rwkv time-mix pair) and
``windows`` gives the per-attention-layer sliding window (0 = global) so
heterogeneous stacks (gemma3 5:1 local:global, recurrentgemma 1:2) stay in
homogeneous scans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    windows: Tuple[int, ...] = ()  # per-layer (0=global); () -> all global
    layer_kinds: Tuple[str, ...] = ()  # per-layer kind; () -> all 'a'
    rope_theta: float = 1e4
    act: str = "silu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid / ssm
    d_rnn: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0
    # modality frontend stub
    frontend: str = "none"         # none | vision_stub | audio_stub
    n_patches: int = 0
    # depth-gradient policy (the paper's technique over layers)
    remat: str = "sqrt"            # none | full | sqrt | revolve
    ncheck: Optional[int] = None
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"
    # notes
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kinds(self) -> Tuple[str, ...]:
        if self.layer_kinds:
            return self.layer_kinds
        return ("a",) * self.n_layers

    @property
    def win(self) -> Tuple[int, ...]:
        if self.windows:
            return self.windows
        return (0,) * self.n_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dh, hf = self.d_model, self.dh, self.d_ff
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.kinds:
            if kind == "a":
                n += d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
                if self.n_experts:
                    n += d * self.n_experts + self.n_experts * 3 * d * hf
                else:
                    n += 3 * d * hf
                n += 2 * d
            elif kind == "w":
                n += 6 * d * d + d * hf + hf * d + 2 * d
            elif kind == "r":
                dr = self.d_rnn or d
                n += 2 * d * dr + dr * d + 2 * dr * dr + 3 * d * hf + 2 * d
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                n += d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
                n += 2 * d * hf + 2 * d
            # decoder cross-attention
            n += self.n_layers * (d * self.n_heads * dh * 2
                                  + d * self.n_kv_heads * dh * 2)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, hf = self.d_model, self.d_ff
        dense_expert = self.n_experts * 3 * d * hf
        active_expert = self.top_k * 3 * d * hf
        return self.param_count() - self.n_layers * (dense_expert - active_expert)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# archs for which long_500k runs (sub-quadratic sequence mixing); all others
# skip it with a note (see DESIGN.md §Arch-applicability)
LONG_CONTEXT_OK = ("gemma3-4b", "recurrentgemma-9b", "rwkv6-7b", "mixtral-8x7b")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    n_layers = overrides.pop("n_layers", min(cfg.n_layers, 4))
    kinds = cfg.kinds[:n_layers]
    wins = tuple(min(w, 8) if w else 0 for w in cfg.win[:n_layers])
    base = dict(
        name=cfg.name + "-smoke", family=cfg.family, n_layers=n_layers,
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128, vocab_size=256,
        head_dim=16, windows=wins, layer_kinds=kinds,
        rope_theta=cfg.rope_theta, act=cfg.act, norm=cfg.norm,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_rnn=64 if cfg.d_rnn else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        frontend=cfg.frontend, n_patches=8 if cfg.n_patches else 0,
        remat=cfg.remat, ncheck=cfg.ncheck,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="naive", source=cfg.source,
    )
    base.update(overrides)
    return ModelConfig(**base)
