"""Logical-axis sharding rules + GQA tensor-parallel head packing, the
PyTorch counterpart of ``repro/distributed/sharding.py``.

Models annotate tensors with *logical* axis names; ``ParallelConfig``
resolves them to mesh ``PartitionSpec``s (this module's own small tuple
type, with the reference's entries: ``None``, a mesh dim name, or a tuple
of names). The production mesh is ``(pod, data, model)``: ``batch →
(pod, data)`` and all model-parallel dims → ``model``. ``placements`` turns
a spec into DTensor placements on a ``DeviceMesh`` from
``torch.distributed.device_mesh.init_device_mesh``, and ``place_tree``
places a tree of tensors by a tree of specs.

GQA packing: JAX rejects uneven input shardings, and so does ``placements``
(DTensor alone would accept them), so Q/KV heads are packed into a
``[KVp, q_per_slot, head_dim]`` layout where ``KVp`` is a TP multiple. KV
heads are *duplicated* (not zero-padded) across slots so every slot computes
real attention; Q-head slots beyond the true count carry zero weights
(exact math).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# logical axis name -> role
_TP_AXES = frozenset({
    "heads", "kv_heads", "ff", "vocab", "expert", "d_inner", "wkv_heads", "q_slots",
})
_DP_AXES = frozenset({"batch"})


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (not sharded), a mesh dim name, or
    a tuple of mesh dim names (sharded over their product, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class ParallelConfig:
    """Resolved parallelism layout for one mesh."""

    dp_axes: Tuple[str, ...] = ()       # mesh axes carrying the batch (e.g. ('pod','data'))
    tp_axis: Optional[str] = None       # mesh axis carrying model parallelism
    tp: int = 1                         # size of tp_axis
    dp: int = 1                         # product size of dp_axes

    @staticmethod
    def single_device() -> "ParallelConfig":
        return ParallelConfig()

    @staticmethod
    def from_mesh(mesh) -> "ParallelConfig":
        """From a ``DeviceMesh``: its ``model`` dim is TP, every other dim DP."""
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
        tp_axis = "model" if "model" in names else None
        dp_axes = tuple(n for n in names if n != "model")
        dp = int(np.prod([sizes[n] for n in dp_axes])) if dp_axes else 1
        return ParallelConfig(dp_axes=dp_axes, tp_axis=tp_axis,
                              tp=sizes.get("model", 1), dp=dp)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """Resolve a tuple of logical axis names to a PartitionSpec."""
        out = []
        for name in logical:
            if name is None:
                out.append(None)
            elif name in _DP_AXES:
                out.append(self.dp_axes if len(self.dp_axes) != 1 else self.dp_axes[0])
                if not self.dp_axes:
                    out[-1] = None
            elif name in _TP_AXES:
                out.append(self.tp_axis)
            else:
                raise ValueError(f"unknown logical axis {name!r}")
        return PartitionSpec(*out)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, mesh, shape) -> List:
    """DTensor placements of a tensor of ``shape`` laid out by ``spec`` on
    ``mesh``: one per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that
    mesh dim, ``Replicate()`` elsewhere. A tensor dim over several mesh dims
    is ``Shard(d)`` on each, in row-major order, as JAX lays out
    ``("pod", "data")``. Raises ``ValueError`` on a dim that its mesh dims do
    not divide (JAX refuses such an input sharding), on a mesh dim named
    twice, and on a name the mesh does not have."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _names(entry)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec}: mesh {names} has no dim {a!r}")
        idx = [names.index(a) for a in axes]
        # DTensor shards a dim over its mesh dims in the mesh's order
        if idx != sorted(set(idx)):
            raise ValueError(f"spec {spec}: dim {d}'s mesh dims are repeated "
                             f"or not in the mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} names mesh dim {names[i]!r} twice")
            out[i] = Shard(d)
        n = math.prod(sizes[a] for a in axes)
        if shape[d] % n:
            raise ValueError(
                f"dim {d} of shape {tuple(shape)} is not divisible by {n}, the "
                f"size of mesh dims {axes} (spec {spec}): an uneven sharding")
    return out


def place(x: torch.Tensor, mesh, spec):
    """``x`` (the same full tensor on every rank) as a DTensor laid out by
    ``spec``; each rank keeps its own shard, with no communication. A
    DTensor is gathered to its full value first (a move between meshes or
    layouts)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return distribute_tensor(x, mesh, placements(spec, mesh, x.shape),
                             src_data_rank=None)


def place_tree(tree, mesh, specs):
    """Every leaf of ``tree`` placed by the leaf of ``specs`` at its path
    (nested dicts; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return place(tree, mesh, specs)


def local_tree(tree):
    """Each rank's own shard of every DTensor leaf (plain tensors pass)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def from_local(x: torch.Tensor, mesh, spec) -> DTensor:
    """This rank's shard ``x`` as a DTensor laid out by ``spec``: the global
    shape is the local one times the mesh dims that each tensor dim names
    (no communication)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shape = list(x.shape)
    for d, entry in enumerate(spec):
        shape[d] *= math.prod(sizes[a] for a in _names(entry))
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(x, mesh, placements(spec, mesh, shape),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def dp_rank(mesh, pc: ParallelConfig) -> int:
    """This rank's index along the batch: its coordinates on the DP axes,
    row-major (the block of a batch dim that ``placements`` gives it)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = 0
    for a in pc.dp_axes:
        out = out * sizes[a] + mesh.get_local_rank(a)
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GQALayout:
    """Padded/duplicated GQA head layout for a given TP degree.

    - ``kv_slots`` (KVp): KV head slots, divisible by tp. ``dup_map[s]`` gives the
      true KV head stored in slot ``s`` (duplication, exact).
    - ``q_per_slot`` (qps): Q heads per slot; ``q_map[s, j]`` gives the true Q head
      index or -1 for a zero-weight pad slot.
    """

    num_heads: int
    num_kv_heads: int
    tp: int
    kv_slots: int
    q_per_slot: int
    dup_map: Tuple[int, ...]
    q_map: Tuple[Tuple[int, ...], ...]

    @property
    def padded_q_heads(self) -> int:
        return self.kv_slots * self.q_per_slot

    @property
    def q_flop_waste(self) -> float:
        """Fraction of attention Q-side compute spent on padding."""
        return self.padded_q_heads / self.num_heads - 1.0

    def dup_array(self) -> np.ndarray:
        return np.asarray(self.dup_map, dtype=np.int32)

    def q_array(self) -> np.ndarray:
        return np.asarray(self.q_map, dtype=np.int32)


def gqa_layout(num_heads: int, num_kv_heads: int, tp: int) -> GQALayout:
    qpk = num_heads // num_kv_heads
    assert num_heads == qpk * num_kv_heads, "num_heads must be a multiple of num_kv_heads"
    if tp <= 1:
        dup = tuple(range(num_kv_heads))
        qmap = tuple(tuple(k * qpk + j for j in range(qpk)) for k in range(num_kv_heads))
        return GQALayout(num_heads, num_kv_heads, 1, num_kv_heads, qpk, dup, qmap)
    kvp = round_up(num_kv_heads, tp)
    # distribute slots over true KV heads as evenly as possible, monotone
    dup = tuple(s * num_kv_heads // kvp for s in range(kvp))
    counts = [0] * num_kv_heads
    for k in dup:
        counts[k] += 1
    min_slots = min(counts)
    qps = math.ceil(qpk / min_slots)
    qmap = []
    first_slot = {}
    for s, k in enumerate(dup):
        if k not in first_slot:
            first_slot[k] = s
        rank = s - first_slot[k]
        row = []
        for j in range(qps):
            p = rank * qps + j
            row.append(k * qpk + p if p < qpk else -1)
        qmap.append(tuple(row))
    return GQALayout(num_heads, num_kv_heads, tp, kvp, qps, dup, tuple(qmap))


def pack_q_weight(w: np.ndarray, layout: GQALayout, head_axis: int = 1) -> np.ndarray:
    """Pack canonical per-Q-head weight ``[..., H, ...]`` to ``[..., KVp*qps, ...]``.

    Pad slots get zeros — with zero output-projection rows the math is exact.
    """
    w = np.moveaxis(w, head_axis, 0)
    out = np.zeros((layout.padded_q_heads,) + w.shape[1:], dtype=w.dtype)
    for s in range(layout.kv_slots):
        for j in range(layout.q_per_slot):
            src = layout.q_map[s][j]
            if src >= 0:
                out[s * layout.q_per_slot + j] = w[src]
    return np.moveaxis(out, 0, head_axis)


def pack_kv_weight(w: np.ndarray, layout: GQALayout, head_axis: int = 1) -> np.ndarray:
    """Duplicate canonical per-KV-head weight ``[..., KV, ...]`` into slots."""
    w = np.moveaxis(w, head_axis, 0)
    out = w[layout.dup_array()]
    return np.moveaxis(out, 0, head_axis)


def unpack_q_output(o: np.ndarray, layout: GQALayout, head_axis: int = 1) -> np.ndarray:
    """Inverse of pack_q_weight for comparing against canonical reference."""
    o = np.moveaxis(o, head_axis, 0)
    out = np.zeros((layout.num_heads,) + o.shape[1:], dtype=o.dtype)
    for s in range(layout.kv_slots):
        for j in range(layout.q_per_slot):
            src = layout.q_map[s][j]
            if src >= 0:
                out[src] = o[s * layout.q_per_slot + j]
    return np.moveaxis(out, 0, head_axis)


def shardable(dim: int, tp: int) -> bool:
    return tp <= 1 or dim % tp == 0


def tp_dim(logical_size: int, pc: ParallelConfig) -> Optional[str]:
    """Return 'ff'-style tp logical name only when the dim divides the TP degree."""
    return "ff" if shardable(logical_size, pc.tp) else None
