"""Parameter templates: one declaration drives abstract shapes, shardings
and initialisation.

A template tree mirrors the parameter tree (nested dicts); leaves are
``ParamTemplate``, each with its logical axis names. ``init_params`` draws
every leaf from one explicit ``torch.Generator`` on that generator's device,
with the reference's distributions: normal / sqrt(fan_in), zeros, ones, or
a custom draw; whole, or (``by_layer``) one layer group at a time;
``shard_params`` then places the tree on a ``DeviceMesh`` by
``param_specs``.

The tree helpers at the end walk parameter and optimizer-state trees in the
order ``jax.tree_util`` does, which the optimizer's casts and the
checkpoint's file numbering follow.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ParallelConfig, place_tree, placements


@dataclass(frozen=True)
class ParamTemplate:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    fan_in: Optional[int] = None  # overrides scale for 'normal'
    # (generator, n) -> float32 tensor on the generator's device holding
    # the first n entries of the leading axis (packed weights): n is
    # shape[0] for a whole draw, 1 for one group of a by-layer draw
    custom: Optional[Callable[[torch.Generator, int], torch.Tensor]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")


def t(shape, logical, init="normal", fan_in=None, custom=None) -> ParamTemplate:
    return ParamTemplate(tuple(shape), tuple(logical), init, fan_in, custom)


def map_templates(fn, tree):
    if isinstance(tree, ParamTemplate):
        return fn(tree)
    return {k: map_templates(fn, v) for k, v in tree.items()}


def abstract_params(templates, dtype: torch.dtype = torch.bfloat16):
    """Shapes and dtype only: a tree of tensors on the ``meta`` device."""
    return map_templates(
        lambda tm: torch.empty(tm.shape, dtype=dtype, device="meta"), templates)


def param_specs(templates, pc: ParallelConfig):
    return map_templates(lambda tm: pc.spec(*tm.logical), templates)


def param_shardings(templates, pc: ParallelConfig, mesh):
    """Each leaf's DTensor placements on ``mesh`` (raises on an uneven one)."""
    return map_templates(
        lambda tm: placements(pc.spec(*tm.logical), mesh, tm.shape), templates)


def shard_params(params, templates, pc: ParallelConfig, mesh):
    """``params`` (the same full tree on every rank, e.g. drawn from one
    seed) as DTensors on ``mesh``, each leaf placed by its spec: the
    counterpart of the reference's ``param_shardings`` + ``device_put``."""
    return place_tree(params, mesh, param_specs(templates, pc))


def init_params(templates, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, by_layer: bool = False):
    """Materialise ``templates`` on ``generator.device`` in ``dtype``.

    ``by_layer``: each leaf of a sub-tree (``blocks``; whisper's ``enc`` and
    ``dec``), which is stacked on a leading layer-group axis, is allocated
    once in ``dtype`` and filled one group at a time, scaled in place. The
    init's peak is then the tree plus about two float32 groups, where the
    whole draw holds the largest leaf in float32 once or twice (the
    ``[64, 1, 5120, 27648]`` MLP leaves of qwen2.5-32b take 36 GB so). The
    same distributions; on CUDA other numbers than the whole draw of the
    same seed. Top-level leaves (embedding, final norm, head) are drawn
    whole either way."""
    device = generator.device

    def draw(tm: ParamTemplate, n: int) -> torch.Tensor:
        """The leaf's first ``n`` entries of its leading axis, float32."""
        if tm.custom is not None:
            return tm.custom(generator, n)
        fan_in = tm.fan_in if tm.fan_in is not None else (
            tm.shape[-2] if len(tm.shape) >= 2 else tm.shape[-1])
        std = 1.0 / math.sqrt(max(1, fan_in))
        w = torch.randn((n,) + tm.shape[1:], generator=generator,
                        dtype=torch.float32, device=device)
        return w.mul_(std)

    def init(tm: ParamTemplate, stacked: bool) -> torch.Tensor:
        if tm.custom is None and tm.init == "zeros":
            return torch.zeros(tm.shape, dtype=dtype, device=device)
        if tm.custom is None and tm.init == "ones":
            return torch.ones(tm.shape, dtype=dtype, device=device)
        if not (by_layer and stacked):
            return draw(tm, tm.shape[0]).to(dtype)
        out = torch.empty(tm.shape, dtype=dtype, device=device)
        for g in range(tm.shape[0]):
            out[g:g + 1].copy_(draw(tm, 1))
        return out

    return {k: (init(v, False) if isinstance(v, ParamTemplate)
                else map_templates(lambda tm: init(tm, True), v))
            for k, v in templates.items()}


def count_params(templates) -> int:
    total = [0]

    def add(tm: ParamTemplate):
        total[0] += int(np.prod(tm.shape))
        return tm

    map_templates(add, templates)
    return total[0]


# --------------------------------------------------------------------------
# parameter / optimizer-state trees: nested dicts of tensors, None no leaf
# --------------------------------------------------------------------------
def tree_flatten(tree, prefix: str = "") -> Tuple[List[str], List]:
    """(paths, leaves) of a nested dict in sorted-key order, the order in
    which ``jax.tree_util`` flattens dicts; paths join keys with '/' (e.g.
    ``blocks/wq``) and ``None`` is no leaf, as in JAX."""
    if tree is None:
        return [], []
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths, leaves = [], []
    for k in sorted(tree):
        p, lv = tree_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        paths += p
        leaves += lv
    return paths, leaves


def tree_unflatten(template, leaves):
    """A tree shaped as ``template`` holding ``leaves`` (in ``tree_flatten``
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unstack(stacked) -> List[dict]:
    """Per-layer views of a dict of tensors stacked on axis 0. One ``unbind``
    per tensor, so autograd stacks each tensor's layer gradients once; taking
    ``tensor[g]`` per layer would add a zero-filled gradient of the whole
    stack per layer."""
    names = list(stacked)
    return [dict(zip(names, views))
            for views in zip(*(stacked[k].unbind(0) for k in names))]
