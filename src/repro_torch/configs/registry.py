"""Architecture registry: ``--arch <id>`` resolution for all launchers."""
from __future__ import annotations

from repro_torch.configs.base import (LONG_CONTEXT_OK, SHAPES, ModelConfig,
                                ShapeCell, reduced)
from repro_torch.configs.dbrx_132b import CONFIG as DBRX
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3
from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.whisper_medium import CONFIG as WHISPER

ARCHS = {c.name: c for c in (
    SMOLLM, PHI3, TINYLLAMA, GEMMA3, LLAVA, RECURRENTGEMMA, RWKV6, DBRX,
    MIXTRAL, WHISPER)}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def get_shape(name: str) -> ShapeCell:
    return SHAPES[name]


def cell_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and the skip reason if not."""
    cfg = get_arch(arch)
    cell = get_shape(shape)
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("pure full-attention (or <=448-token decoder): no "
                       "sub-quadratic path for a 512k KV cache; see DESIGN.md")
    if cell.kind == "decode" and cfg.family == "encdec" and shape == "long_500k":
        return False, "whisper decoder max context is 448"
    return True, ""


def all_cells():
    for a in ARCHS:
        for s in SHAPES:
            yield a, s
