"""Hash-block prefix cache (vLLM-style) with ref-count-aware LRU eviction.

Token sequences are split into fixed-size blocks; each block's key chains the
previous block's hash so a hit means the *entire* prefix up to that block is
cached. ``count_cached`` is the DPU's utok oracle; the real executor can attach
per-block KV tensors for genuine compute reuse.

Keys are 64-bit chained crc32 pairs, not Python ``hash``: the builtin is
salted per process (PYTHONHASHSEED), and block keys flow into scheduling
order, the shared-KV admission ledger and the router — every one of which
must be reproducible across interpreter invocations. A single 32-bit crc
would make birthday collisions likely at the default 65536-block capacity
(false hits corrupt utok estimates, admission discounts and — in the real
executor — reused KV payloads); the pair keeps collisions at ~2^-64 while
staying deterministic everywhere zlib is.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence


def iter_block_hashes(tokens: Sequence[int], block_size: int) -> Iterator[int]:
    """Lazily yield 64-bit chained keys of all *full* blocks of ``tokens``
    (two independently-chained crc32 halves). Two sequences share the key of
    block i iff their first (i+1) blocks are token-identical — key equality
    certifies the whole prefix."""
    h = 0
    for i in range(len(tokens) // block_size):
        blk = tokens[i * block_size:(i + 1) * block_size]
        data = b",".join(b"%d" % t for t in blk)
        lo = zlib.crc32(data, h & 0xFFFFFFFF)
        hi = zlib.crc32(data + b"|", h >> 32)
        h = (hi << 32) | lo
        yield h


def block_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chained hashes of all *full* blocks of ``tokens``."""
    return list(iter_block_hashes(tokens, block_size))


@dataclass
class CachedBlock:
    key: int
    ref_count: int = 0
    payload: Any = None      # optional per-layer KV tensors (real executor)


class PrefixCache:
    def __init__(self, block_size: int = 16, capacity_blocks: int = 65536):
        self.block_size = block_size
        self.capacity_blocks = capacity_blocks
        self._blocks: "OrderedDict[int, CachedBlock]" = OrderedDict()
        # pins for blocks that may not be resident yet: the scheduler acquires
        # a request's prompt keys at KV-charge time, which can precede the
        # executor's insert (the prefill that writes the blocks)
        self._pins: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._blocks)

    # ---------------------------------------------------------------- lookup
    def match_blocks(self, tokens: Sequence[int]) -> List[int]:
        """Keys of the longest cached block-prefix (touches LRU)."""
        matched = []
        for key in iter_block_hashes(tokens, self.block_size):
            if key in self._blocks:
                self._blocks.move_to_end(key)
                matched.append(key)
            else:
                break
        return matched

    def count_cached(self, tokens: Sequence[int]) -> int:
        """Cached-token count for a prompt (DPU's Eq. 11 oracle)."""
        n = len(self.match_blocks(tokens)) * self.block_size
        self.hits += n
        self.misses += max(0, len(tokens) - n)
        return n

    def peek_cached(self, tokens: Sequence[int]) -> int:
        """count_cached without stats/LRU side effects (scheduling probes)."""
        n = 0
        for h in iter_block_hashes(tokens, self.block_size):
            if h in self._blocks:
                n += self.block_size
            else:
                break
        return n

    def has_block(self, key: int) -> bool:
        """Residency probe by key — no stats, no LRU touch."""
        return key in self._blocks

    def get_payloads(self, tokens: Sequence[int]) -> List[Any]:
        return [self._blocks[k].payload for k in self.match_blocks(tokens)]

    # ---------------------------------------------------------------- pinning
    def ref_count(self, key: int) -> int:
        block = self._blocks.get(key)
        return (block.ref_count if block is not None else 0) + \
            self._pins.get(key, 0)

    def acquire_blocks(self, keys: Sequence[int]) -> None:
        """Pin ``keys`` against LRU eviction while a request's KV depends on
        them. Keys not (yet) resident are remembered: the pin attaches when
        the executor inserts the block."""
        for key in keys:
            block = self._blocks.get(key)
            if block is not None:
                block.ref_count += 1
            else:
                self._pins[key] = self._pins.get(key, 0) + 1

    def release_blocks(self, keys: Sequence[int]) -> None:
        """Undo one ``acquire_blocks``; unknown keys are a no-op."""
        for key in keys:
            block = self._blocks.get(key)
            if block is not None and block.ref_count > 0:
                block.ref_count -= 1
            elif key in self._pins:
                self._pins[key] -= 1
                if self._pins[key] <= 0:
                    del self._pins[key]

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], payloads: Optional[List[Any]] = None) -> None:
        for i, key in enumerate(iter_block_hashes(tokens, self.block_size)):
            if key in self._blocks:
                self._blocks.move_to_end(key)
                continue
            self._blocks[key] = CachedBlock(
                key, ref_count=self._pins.pop(key, 0),
                payload=payloads[i] if payloads and i < len(payloads) else None)
            self._evict_to_capacity()

    def _evict_to_capacity(self) -> None:
        """Evict oldest *unreferenced* blocks down to capacity. Referenced
        blocks back live KV (a scheduled request's shared prefix) and are
        never dropped — when everything over capacity is pinned, the cache
        temporarily exceeds ``capacity_blocks`` instead. The walk starts at
        the LRU end and stops as soon as the excess is covered, so the
        steady-state insert cost is O(evictions + pinned blocks skipped),
        not O(cache size)."""
        excess = len(self._blocks) - self.capacity_blocks
        if excess <= 0:
            return
        victims = []
        for key, block in self._blocks.items():   # oldest first
            if block.ref_count == 0:
                victims.append(key)
                if len(victims) >= excess:
                    break
        for key in victims:
            del self._blocks[key]
            self.evictions += 1

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
