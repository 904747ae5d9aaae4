"""Config registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``.

Every arch of the JAX package is listed: the dense family and the VLM
backbone (``DenseTransformer``: full attention, qkv bias, gemma3's
local:global layers, ``extra_embeds``), the MoE family
(``MoETransformer``), rwkv6-7b (``RWKV6Model``), hymba-1.5b
(``HymbaModel``) and whisper-base (``WhisperModel``).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (
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


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
