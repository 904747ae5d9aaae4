"""Model registry: arch family -> model class; ``build_model`` is the single
entry point used by the engine, launchers and tests. Only the dense family is
ported so far."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DenseTransformer

_FAMILIES = {
    "dense": DenseTransformer,
}
# families the JAX package serves that have no counterpart here yet
_NOT_PORTED = ("vlm", "moe", "hybrid", "ssm", "audio")


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
