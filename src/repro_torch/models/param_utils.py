"""Parameter templates: one declaration drives shapes and initialisation.

A template tree mirrors the parameter tree (nested dicts); leaves are
``ParamTemplate``. ``init_params`` draws every leaf from one explicit
``torch.Generator`` on that generator's device, with the reference's
distributions: normal / sqrt(fan_in), zeros, ones, or a custom draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamTemplate:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    fan_in: Optional[int] = None  # overrides scale for 'normal'
    # generator -> float32 tensor on the generator's device (packed weights)
    custom: Optional[Callable[[torch.Generator], torch.Tensor]] = None


def t(shape, init="normal", fan_in=None, custom=None) -> ParamTemplate:
    return ParamTemplate(tuple(shape), init, fan_in, custom)


def _map_leaves(fn, tree):
    if isinstance(tree, ParamTemplate):
        return fn(tree)
    return {k: _map_leaves(fn, v) for k, v in tree.items()}


def init_params(templates, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16):
    """Materialise ``templates`` on ``generator.device`` in ``dtype``."""
    device = generator.device

    def init(tm: ParamTemplate) -> torch.Tensor:
        if tm.custom is not None:
            return tm.custom(generator).to(dtype)
        if tm.init == "zeros":
            return torch.zeros(tm.shape, dtype=dtype, device=device)
        if tm.init == "ones":
            return torch.ones(tm.shape, dtype=dtype, device=device)
        fan_in = tm.fan_in if tm.fan_in is not None else (
            tm.shape[-2] if len(tm.shape) >= 2 else tm.shape[-1])
        std = 1.0 / math.sqrt(max(1, fan_in))
        w = torch.randn(tm.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * std).to(dtype)

    return _map_leaves(init, templates)


def count_params(templates) -> int:
    total = [0]

    def add(tm: ParamTemplate):
        total[0] += int(np.prod(tm.shape))
        return tm

    _map_leaves(add, templates)
    return total[0]
