"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
)

from repro_torch.configs import (  # noqa: E402
    gemma3_12b,
    granite_moe_3b,
    hymba_1p5b,
    internvl2_26b,
    qwen2_0p5b,
    qwen2p5_32b,
    qwen3_1p7b,
    qwen3_moe_30b,
    rwkv6_7b,
    whisper_base,
)

_MODULES = {
    "qwen3-1.7b": qwen3_1p7b,
    "qwen2-0.5b": qwen2_0p5b,
    "gemma3-12b": gemma3_12b,
    "qwen2.5-32b": qwen2p5_32b,
    "hymba-1.5b": hymba_1p5b,
    "rwkv6-7b": rwkv6_7b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "whisper-base": whisper_base,
    "internvl2-26b": internvl2_26b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch].SMOKE_CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def all_cells() -> List[tuple]:
    """The 40 assigned (arch, shape) cells, with skip annotations."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            cells.append((arch, shape.name, cfg.supports_shape(shape)))
    return cells
