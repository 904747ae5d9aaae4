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
rank's own block of the gradient backward: right where every rank computes
the same thing from the gathered tensor. ``gather_scatter`` all-gathers
forward and reduce-scatters the gradient backward: right where each rank
computes from the gathered tensor something of its own (hymba's ``m_in``
columns, a fully sharded parameter on each rank's rows), so that every
rank's gradient of the whole is a part of the sum. ``torch.distributed.nn``'s
all-reduce is no use for ``reduce``: it all-reduces the gradient in its
backward too, which multiplies the gradients by the size of the group.

Each call issues one ``torch.distributed`` collective (forward or backward)
on the group it is given and adds one to ``collective_counts()``.
``layers.chunked_softmax_xent`` takes a ``Region`` for its cross-entropy
over vocab columns that the ranks share out.

``MeshModel`` is what a model family needs to run its steps on a mesh:
DTensor parameters to each rank's shards (gathered per layer group where
the fully sharded layout puts them on the data axes), each rank's rows of
an input, and outputs placed back on the mesh.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.distributed.sharding import dp_rank, from_local

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
        ctx.group, ctx.dim, ctx.cols = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        part = x.movedim(dim, 0).contiguous()
        full = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        _calls["all_gather_into_tensor"] += 1
        dist.all_gather_into_tensor(full, part, group=group)
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.cols, ctx.cols), None, None


class _GatherScatter(_Gather):
    @staticmethod
    def backward(ctx, grad):
        full = grad.movedim(ctx.dim, 0).contiguous()
        part = full.new_empty((ctx.cols,) + tuple(full.shape[1:]))
        _calls["reduce_scatter_tensor"] += 1
        dist.reduce_scatter_tensor(part, full, group=ctx.group)
        return part.movedim(0, ctx.dim), None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return _Enter.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, group, dim % x.ndim)


def gather_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherScatter.apply(x, group, dim % x.ndim)


class Region:
    """The model axis's group, or none (one device, or the fully sharded
    layout: every edge is the identity and nothing is issued), with the
    data-parallel axes' groups. ``fsdp`` maps ``(stack, leaf)`` of a layer
    stack whose leaves the fully sharded layout keeps on the data axes to
    the dim of a layer's slice that they shard and the groups to gather it
    over, innermost mesh dim first (``MeshModel._local_params`` fills it)."""

    def __init__(self, group=None, dp_groups: Tuple = ()):
        self.group = group
        self.dp_groups = dp_groups
        self.fsdp: Dict[Tuple[str, str], Tuple[int, list]] = {}

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.active else 0

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if self.active else 1

    def enter(self, x):
        return enter(x, self.group) if self.active else x

    def reduce(self, x):
        return reduce(x, self.group) if self.active else x

    def gather(self, x, dim: int = -1):
        return gather(x, self.group, dim) if self.active else x

    def gather_scatter(self, x, dim: int = -1):
        return gather_scatter(x, self.group, dim) if self.active else x

    def cols(self, x, dim: int = -1):
        """The rank's block of ``x`` along ``dim`` (of a tensor every rank
        holds whole): what a column-parallel weight's shard covers."""
        if not self.active:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

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

    def lookup(self, emb, tokens):
        """Rows ``tokens`` of an embedding table whose rows (the vocab) the
        ranks share out: each rank's hits in its own block, reduced."""
        if not self.active:
            return emb[tokens.long()]
        n = emb.shape[0]
        idx = tokens.long() - self.rank * n
        hit = (idx >= 0) & (idx < n)
        return self.reduce(emb[idx.clamp(0, n - 1)] * hit[..., None].to(emb.dtype))

    def gather_group(self, stack: str, pp: dict) -> dict:
        """A layer group's leaves of ``stack`` whole: each that ``fsdp``
        names all-gathered (``gather_scatter``) on the group's slice. Called
        inside the group's step, so that remat gathers again."""
        if not self.fsdp:
            return pp
        out = dict(pp)
        for name, x in pp.items():
            if (stack, name) in self.fsdp:
                dim, groups = self.fsdp[stack, name]
                for g in groups:
                    x = gather_scatter(x, g, dim)
                out[name] = x
        return out


NO_REGION = Region()


def region_of(mesh, pc) -> Region:
    """The region of ``pc``'s model axis on ``mesh`` (none where ``pc`` has
    none: the fully sharded layout), with its DP groups."""
    return Region(mesh.get_group(pc.tp_axis) if pc.tp_axis else None,
                  tuple(mesh.get_group(a) for a in pc.dp_axes))


def _dp_shards(x, pc) -> Tuple[list, list]:
    """The data-parallel mesh dims that shard DTensor ``x`` (the fully
    sharded layout's parameters): their indices and groups, innermost
    first."""
    names = x.device_mesh.mesh_dim_names
    idx = [i for i, (n, p) in enumerate(zip(names, x.placements))
           if n in pc.dp_axes and isinstance(p, Shard)]
    return idx, [x.device_mesh.get_group(names[i]) for i in reversed(idx)]


def grad_placements(x, pc) -> list:
    """A DTensor parameter's gradient placements: ``Partial`` (a sum) over
    the DP axes that do not shard it, where each rank's gradient is its
    rows' part, and the parameter's own placement on every other mesh dim
    (on a DP axis that shards it, ``gather_scatter`` has already summed
    and scattered the gradient)."""
    names = x.device_mesh.mesh_dim_names
    return [Partial() if name in pc.dp_axes and not isinstance(p, Shard) else p
            for name, p in zip(names, x.placements)]


class MeshModel:
    """The mesh plumbing of a model family's steps. With ``mesh`` set and
    DTensor parameters placed by ``param_specs()`` (or by the fully sharded
    layout's specs), a step runs in ``_tp_region()`` on
    ``_local_params(params)`` and ``_rows`` of its inputs, and places its
    outputs back with ``_by_batch`` / ``from_local``."""

    # a DeviceMesh: with DTensor parameters the steps run on it
    mesh = None
    # the region of the call in progress (none: one device)
    _region = NO_REGION

    def _sharded(self, params) -> bool:
        return self.mesh is not None and isinstance(params["embed"], DTensor)

    @contextlib.contextmanager
    def _in_region(self, region):
        prev, self._region = self._region, region
        try:
            yield
        finally:
            self._region = prev

    def _tp_region(self):
        return self._in_region(region_of(self.mesh, self.pc))

    def _local_params(self, params):
        """Each rank's shards; under autograd their gradients come back
        ``Partial`` over the DP axes. A leaf that the fully sharded layout
        keeps on the data axes is all-gathered: here, where it lies outside a
        layer stack or is sharded on its layer axis; else per layer group by
        ``Region.gather_group`` (its dims recorded in the region)."""
        region = self._region

        def local(x, stack, name):
            if not isinstance(x, DTensor):
                return x
            if torch.is_grad_enabled() and x.requires_grad:
                y = x.to_local(grad_placements=grad_placements(x, self.pc))
            else:
                y = x.to_local()
            idx, groups = _dp_shards(x, self.pc)
            if not idx:
                return y
            dim = x.placements[idx[0]].dim
            if stack is None or dim == 0:
                for g in groups:
                    y = gather_scatter(y, g, dim)
                return y
            region.fsdp[stack, name] = (dim - 1, groups)
            return y

        return {k: ({n: local(x, k, n) for n, x in v.items()}
                    if isinstance(v, dict) else local(v, None, k))
                for k, v in params.items()}

    def _rows(self, x):
        """This rank's rows of a batch-major input that every rank holds
        whole: its block on the DP axes."""
        if x is None:
            return None
        b = x.shape[0] // self.pc.dp
        if b * self.pc.dp != x.shape[0]:
            raise ValueError(f"batch {x.shape[0]} is not divisible by the "
                             f"{self.pc.dp} data-parallel ranks")
        r0 = dp_rank(self.mesh, self.pc) * b
        return x[r0:r0 + b]

    def _by_batch(self, x):
        return from_local(x, self.mesh,
                          self.pc.spec("batch", *([None] * (x.ndim - 1))))
