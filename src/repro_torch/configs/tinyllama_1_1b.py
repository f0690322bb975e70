"""TinyLlama 1.1B [arXiv:2401.02385] — llama2-arch small, GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab_size=32000, head_dim=64, rope_theta=1e4, act="silu",
    source="arXiv:2401.02385",
)
