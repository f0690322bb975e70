"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].
Backbone only; the anyres vision tiling is a stub: input_specs() provides
precomputed patch embeddings (n_patches x d_model) prepended to the tokens."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    windows=(4096,) * 32,          # mistral sliding-window attention
    rope_theta=1e4, act="silu",
    frontend="vision_stub", n_patches=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
