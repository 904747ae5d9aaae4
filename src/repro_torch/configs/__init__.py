"""Config registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` for the archs the port serves so far.

Listed are the archs whose family the port's models cover: the dense
full-attention archs (``DenseTransformer``) and rwkv6-7b (``RWKV6Model``).
Any other arch id of the JAX package raises ``KeyError`` saying it is not
ported.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import qwen2_0p5b, qwen3_1p7b, rwkv6_7b

_MODULES = {
    "qwen3-1.7b": qwen3_1p7b,
    "qwen2-0.5b": qwen2_0p5b,
    "rwkv6-7b": rwkv6_7b,
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch yet; "
                       f"ported: {ARCH_IDS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
