"""Tensor-parallel collectives with gradients of their own, for the
whole-model forward on a ``DeviceMesh`` (``models/transformer.py``), where
the reference leaves them to GSPMD.

The Megatron pair marks the edges of a tensor-parallel region, in which each
rank of the model axis computes on its own shard of the weights:

- ``enter`` ("copy to the region"): the identity forward; the backward
  all-reduces the gradient, since every rank's shard adds a part of it;
- ``reduce`` ("reduce from the region"): an all-reduce (sum) of the ranks'
  partial results forward; the identity backward, since every rank's output
  is the same sum.

``gather`` all-gathers the ranks' column blocks forward and takes the
rank's own block of the gradient backward. ``torch.distributed.nn``'s
all-reduce is no use for ``reduce``: it all-reduces the gradient in its
backward too, which multiplies the gradients by the size of the group.

Each call issues one ``torch.distributed`` collective (forward or backward)
on the group it is given and adds one to ``collective_counts()``.
``layers.chunked_softmax_xent`` takes a ``Region`` for its cross-entropy
over vocab columns that the ranks share out.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial

_calls: Counter = Counter()


def collective_counts() -> Dict[str, int]:
    return dict(_calls)


def reset_collective_counts() -> None:
    _calls.clear()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` all-reduced over ``group`` in place (no gradient); counted."""
    _calls["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.cols = dim, dist.get_rank(group), x.shape[dim]
        part = x.movedim(dim, 0).contiguous()
        full = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        _calls["all_gather_into_tensor"] += 1
        dist.all_gather_into_tensor(full, part, group=group)
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.cols, ctx.cols), None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return _Enter.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, group, dim % x.ndim)


class Region:
    """The model axis's group, or none (one device: every edge is the
    identity and nothing is issued)."""

    def __init__(self, group=None, dp_groups: Tuple = ()):
        self.group = group
        self.dp_groups = dp_groups

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.active else 0

    def enter(self, x):
        return enter(x, self.group) if self.active else x

    def reduce(self, x):
        return reduce(x, self.group) if self.active else x

    def gather(self, x, dim: int = -1):
        return gather(x, self.group, dim) if self.active else x

    def max(self, x):
        """The elementwise max over the ranks, detached (no gradient)."""
        x = x.detach()
        if self.active:
            x = all_reduce(x.clone(), self.group, dist.ReduceOp.MAX)
        return x

    def reduce_dp(self, x):
        """A sum over the data-parallel axes (identity backward: each rank's
        gradient is its own rows' part, summed later over the same axes)."""
        for g in self.dp_groups:
            x = reduce(x, g)
        return x


NO_REGION = Region()


def region_of(mesh, pc) -> Region:
    """The region of ``pc``'s model axis on ``mesh``, with its DP groups."""
    return Region(mesh.get_group(pc.tp_axis),
                  tuple(mesh.get_group(a) for a in pc.dp_axes))


def grad_placements(x, pc) -> list:
    """A DTensor parameter's gradient placements: ``Partial`` (a sum) over
    the DP axes, where each rank's gradient is its rows' part, and the
    parameter's own placement on every other mesh dim."""
    names = x.device_mesh.mesh_dim_names
    return [Partial() if name in pc.dp_axes else p
            for name, p in zip(names, x.placements)]
