"""Per-device collective traffic and matrix-product FLOPs of a traced cell,
the port's counterpart of ``repro/launch/hlo_stats.py``.

The port compiles no HLO. What takes its place is one run of the cell on one
rank, under ``FakeTensorMode`` on a fake process group
(``launch/cells.py::trace_cell``), during which

- ``CollectiveRecorder`` (a ``TorchDispatchMode``) records every collective
  the rank issues, in-place c10d calls (``dist.all_reduce``) and DTensor's
  functional collectives alike: its kind, the bytes of its output, the size
  of its group and whether the group's ranks share one node;
- ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  operator it has a formula for.

``collective_stats`` applies the reference's wire formulas to the records
and ``dot_flops`` keeps the matrix products (mm, bmm, addmm, baddbmm: 2·M·N·K
each), the reference's definition of a dot's FLOPs. A trace runs every layer
and every backward op, so neither needs the reference's scan correction.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

NODE_SIZE = 8   # cards per node (one HGX H100 board, joined by NVLink)

# c10d and functional collectives -> the reference's kinds; the index of
# the argument that holds the output (None: the first argument's tensors)
_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}


@dataclass(frozen=True)
class CollectiveRecord:
    kind: str          # the reference's kind: all-reduce, all-gather, ...
    out_bytes: int     # bytes of the collectives' outputs on this rank
    group_size: int
    intra_node: bool   # every rank of the group on this rank's node
    calls: int = 1     # collectives of this kind and group it stands for


@dataclass
class CollectiveStats:
    """Per-kind output bytes + wire-byte estimates (per device)."""
    out_bytes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    wire_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_out_bytes(self) -> int:
        return sum(self.out_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def scaled(self, factor: float) -> "CollectiveStats":
        s = CollectiveStats()
        for k in self.out_bytes:
            s.out_bytes[k] = int(self.out_bytes[k] * factor)
            s.wire_bytes[k] = self.wire_bytes[k] * factor
            s.counts[k] = int(self.counts[k] * factor)
        return s

    def add(self, other: "CollectiveStats", factor: float = 1.0) -> "CollectiveStats":
        s = CollectiveStats()
        for k in set(self.out_bytes) | set(other.out_bytes):
            s.out_bytes[k] = self.out_bytes[k] + int(other.out_bytes[k] * factor)
            s.wire_bytes[k] = self.wire_bytes[k] + other.wire_bytes[k] * factor
            s.counts[k] = self.counts[k] + int(other.counts[k] * factor)
        return s


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


def _group(args):
    """The process group of a collective's arguments: a c10d op's boxed
    ``ProcessGroup`` or a functional op's group name."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue            # a boxed ReduceOp
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a)
            except (RuntimeError, ValueError, KeyError):
                continue            # a reduce op's name
    return None


class CollectiveRecorder(TorchDispatchMode):
    """Records each collective issued while inside (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if "c10d" in func.namespace:
            kind = _KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                pg = _group(list(args) + list(kwargs.values()))
                ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
                nodes = {r // NODE_SIZE for r in ranks}
                # c10d ops write their first argument; functional ones return
                held = args[0] if func.namespace == "c10d" else out
                self.records.append(CollectiveRecord(
                    kind, _tensor_bytes(held), len(ranks), len(nodes) == 1))
        return out


def wire_bytes(kind: str, out_b: int, n: int) -> float:
    """The reference's per-device wire-byte estimate of one collective (of
    several of one kind and group size: linear in their output bytes)."""
    n = max(1, n)
    if kind == "all-gather":
        return out_b * (n - 1) / n
    if kind == "all-reduce":
        return 2 * out_b * (n - 1) / n
    if kind == "reduce-scatter":
        return out_b * (n - 1)            # input = n x output
    if kind == "all-to-all":
        return out_b * (n - 1) / n
    return out_b                          # collective-permute


def collective_stats(records) -> CollectiveStats:
    stats = CollectiveStats()
    for r in records:
        stats.out_bytes[r.kind] += r.out_bytes
        stats.wire_bytes[r.kind] += wire_bytes(r.kind, r.out_bytes, r.group_size)
        stats.counts[r.kind] += r.calls
    return stats


DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")


def dot_flops(counter) -> float:
    """Matrix-product FLOPs (2·M·N·K per product) that a
    ``FlopCounterMode`` counted, summed over mm, bmm, addmm and baddbmm."""
    counts = counter.get_flop_counts().get("Global", {})
    return float(sum(n for op, n in counts.items()
                     if getattr(op, "__name__", str(op)).split(".")[0] in DOT_OPS))
