"""Mixtral 8x7B [arXiv:2401.04088] — 8 experts top-2 MoE, sliding-window
attention (4096), GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, windows=(4096,) * 32,
    rope_theta=1e6, act="silu", n_experts=8, top_k=2,
    source="arXiv:2401.04088",
)
