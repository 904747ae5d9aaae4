"""Model registry: arch family -> model class; ``build_model`` is the single
entry point used by the engine, launchers and tests."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParallelConfig
from repro_torch.models.hymba import HymbaModel
from repro_torch.models.moe import MoETransformer
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.transformer import DenseTransformer
from repro_torch.models.whisper import WhisperModel

_FAMILIES = {
    "dense": DenseTransformer,
    "vlm": DenseTransformer,     # LM backbone; patch embeddings via extra_embeds
    "moe": MoETransformer,
    "hybrid": HymbaModel,
    "ssm": RWKV6Model,
    "audio": WhisperModel,
}


def build_model(cfg: ModelConfig, pc: Optional[ParallelConfig] = None):
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r} for arch {cfg.name!r}")
    return cls(cfg, pc)
