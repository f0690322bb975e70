"""Deterministic synthetic token pipeline, the port of
``repro/data/pipeline.py``.

Every batch is a function of (seed, step): a ``torch.Generator`` seeded
from both draws it, so a replayed stream is identical.  Tokens follow the
JAX package's Zipf-like rule (a uniform in [1e-6, 1) cubed, times the
vocabulary, floored), so losses behave like text rather than noise.  The
draws are torch's, not ``jax.random``'s: the same seed gives other tokens
than the JAX package, and tests feed both sides the same numpy tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    cell: ShapeCell
    seed: int = 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "targets"}: (global_batch, seq_len) int32 on the CPU."""
        cfg, cell = self.cfg, self.cell
        if cfg.frontend != "none" or cfg.family == "encdec":
            raise NotImplementedError("frontend and enc-dec inputs are not "
                                      "ported yet (ROADMAP Queue 1 item 13)")
        gen = torch.Generator().manual_seed(
            (int(self.seed) << 32) + int(step))
        u = torch.rand((cell.global_batch, cell.seq_len), generator=gen)
        u = 1e-6 + (1.0 - 1e-6) * u
        ranks = torch.floor((u ** 3.0) * cfg.vocab_size).to(torch.int32)
        tokens = torch.clamp(ranks, 0, cfg.vocab_size - 1)
        return {"tokens": tokens, "targets": tokens}
