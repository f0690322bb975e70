"""Gemma-3 4B [hf:google/gemma-3-1b-pt family] — 5:1 local:global attention,
huge vocab (262144), GQA kv=4, head_dim=256, 128k-class context."""
from repro_torch.configs.base import ModelConfig

_N = 34
_WINDOWS = tuple(0 if (i + 1) % 6 == 0 else 1024 for i in range(_N))

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=_N, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262144, head_dim=256, windows=_WINDOWS,
    rope_theta=1e6, act="gelu", tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
