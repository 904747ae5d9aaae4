"""Model registry: arch family -> model class; ``build_model`` is the single
entry point used by the engine, launchers and tests. Ported so far: the dense
family and the VLM backbone (``DenseTransformer``), the MoE family
(``MoETransformer``) and the ssm family (``RWKV6Model``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoETransformer
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.transformer import DenseTransformer

_FAMILIES = {
    "dense": DenseTransformer,
    "vlm": DenseTransformer,     # LM backbone; patch embeddings via extra_embeds
    "moe": MoETransformer,
    "ssm": RWKV6Model,
}
# families the JAX package serves that have no counterpart here yet
_NOT_PORTED = ("hybrid", "audio")


def build_model(cfg: ModelConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} (arch {cfg.name!r}) is not ported to "
            f"repro_torch yet")
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r} for arch {cfg.name!r}")
    return cls(cfg)
