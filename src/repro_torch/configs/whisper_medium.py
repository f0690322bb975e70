"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; the conv audio
frontend is a stub (input_specs() provides precomputed frame embeddings,
1500 frames x d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, rope_theta=0.0, act="gelu",
    norm="layernorm", n_enc_layers=24, enc_seq=1500,
    frontend="audio_stub",
    source="arXiv:2212.04356",
)
