"""Step functions (prefill / decode), the port of the serving half of
``repro/launch/steps.py``.  The train step comes with training."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, max_seq)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, state, token, pos):
        return lm.decode_step(cfg, params, state, token, pos)

    return decode_step
