"""GQA head packing of the port (the numpy half of
``repro/distributed/sharding.py``; single device, ``tp=1`` in practice).

Q/KV heads are packed into a ``[KVp, q_per_slot, head_dim]`` layout. KV heads
are *duplicated* (not zero-padded) across slots so every slot computes real
attention; Q-head slots beyond the true count carry zero weights (exact math).
``ParallelConfig`` and device meshes are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
