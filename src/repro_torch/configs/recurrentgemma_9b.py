"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — RG-LRU + local attention,
1 attention : 2 recurrent layers, GQA kv=1, head_dim=256."""
from repro_torch.configs.base import ModelConfig

_N = 38
# pattern: (r, r, a) repeated; remainder layers are recurrent
_KINDS = tuple("a" if i % 3 == 2 else "r" for i in range(_N))
_WINDOWS = tuple(2048 if k == "a" else 0 for k in _KINDS)

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=_N, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256, layer_kinds=_KINDS, windows=_WINDOWS,
    rope_theta=1e4, act="gelu", d_rnn=4096,
    source="arXiv:2402.19427",
)
