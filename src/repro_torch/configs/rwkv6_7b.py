"""RWKV-6 (Finch) 7B [arXiv:2404.05892] — attention-free, data-dependent
decay time-mix + squared-relu channel-mix; head_dim 64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0, d_ff=14336,
    vocab_size=65536, head_dim=64,
    layer_kinds=("w",) * 32, rope_theta=0.0, act="relu",
    source="arXiv:2404.05892",
)
