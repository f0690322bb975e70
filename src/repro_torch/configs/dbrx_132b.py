"""DBRX 132B [hf:databricks/dbrx-base] — fine-grained MoE: 16 experts top-4,
GQA kv=8, global attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, head_dim=128, rope_theta=5e5, act="silu",
    n_experts=16, top_k=4,
    source="hf:databricks/dbrx-base",
)
