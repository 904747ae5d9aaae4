"""Paged KV block manager: block-granular accounting of device KV memory with
per-sequence block tables, shared (ref-counted) prefix blocks, and watermark
admission. The Pallas paged-attention kernel consumes exactly this layout
(block_tables [B, max_blocks], context_lens [B]).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


class OutOfBlocks(Exception):
    pass


@dataclass
class SeqAllocation:
    block_ids: List[int]
    num_tokens: int
    shared_prefix_blocks: int = 0


@dataclass
class HostAllocation:
    """A sequence's KV parked on the host tier: one host block per device
    block it occupied at swap-out time (including then-shared prefix blocks —
    the host copy is always self-contained so swap-in never depends on a
    sibling still being resident)."""
    block_ids: List[int]
    num_tokens: int


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int = 16,
                 watermark: float = 0.01, num_host_blocks: int = 0):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_host_blocks = num_host_blocks
        self.watermark_blocks = max(1, int(num_blocks * watermark))
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._seqs: Dict[str, SeqAllocation] = {}
        # prefix-block sharing: hash key -> block id
        self._prefix_blocks: Dict[int, int] = {}
        self._block_keys: Dict[int, int] = {}
        # host tier: swapped-out sequences hold host blocks (never shared)
        self._host_free: List[int] = list(range(num_host_blocks - 1, -1, -1))
        self._host_seqs: Dict[str, HostAllocation] = {}
        # swap-in prefetch staging: seq_id -> fresh device blocks already
        # holding (a copy of) the host image, awaiting commit or cancel. The
        # host allocation stays authoritative until commit.
        self._staged: Dict[str, List[int]] = {}

    # ---------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def can_allocate(self, num_tokens: int, cached_blocks: int = 0) -> bool:
        need = max(0, self.blocks_needed(num_tokens) - cached_blocks)
        return self.free_blocks - need >= self.watermark_blocks

    def block_table(self, seq_id: str) -> List[int]:
        return list(self._seqs[seq_id].block_ids)

    def context_len(self, seq_id: str) -> int:
        return self._seqs[seq_id].num_tokens

    def tokens_in_use(self) -> int:
        return sum(a.num_tokens for a in self._seqs.values())

    @property
    def host_free_blocks(self) -> int:
        return len(self._host_free)

    def host_tokens_in_use(self) -> int:
        return sum(a.num_tokens for a in self._host_seqs.values())

    def is_swapped(self, seq_id: str) -> bool:
        return seq_id in self._host_seqs

    def host_block_table(self, seq_id: str) -> List[int]:
        return list(self._host_seqs[seq_id].block_ids)

    # ---------------------------------------------------------------- alloc
    def allocate(self, seq_id: str, num_tokens: int,
                 prefix_keys: Sequence[int] = ()) -> SeqAllocation:
        """Allocate blocks for a prefilled sequence; reuse shared prefix blocks
        when their keys are resident."""
        if seq_id in self._seqs:
            raise KeyError(f"sequence {seq_id} already allocated")
        shared: List[int] = []
        for key in prefix_keys:
            bid = self._prefix_blocks.get(key)
            if bid is None:
                break
            shared.append(bid)
        need = self.blocks_needed(num_tokens) - len(shared)
        if need > len(self._free):
            raise OutOfBlocks(f"need {need} blocks, have {len(self._free)}")
        fresh = [self._free.pop() for _ in range(max(0, need))]
        for bid in shared + fresh:
            self._ref[bid] = self._ref.get(bid, 0) + 1
        alloc = SeqAllocation(block_ids=shared + fresh, num_tokens=num_tokens,
                              shared_prefix_blocks=len(shared))
        self._seqs[seq_id] = alloc
        return alloc

    def register_prefix(self, seq_id: str, keys: Sequence[int]) -> None:
        """Publish the first len(keys) blocks of a sequence as shared prefix
        blocks (called after prefill writes them)."""
        alloc = self._seqs[seq_id]
        for i, key in enumerate(keys):
            if i >= len(alloc.block_ids):
                break
            bid = alloc.block_ids[i]
            if key not in self._prefix_blocks:
                self._prefix_blocks[key] = bid
                self._block_keys[bid] = key

    def fork(self, parent_id: str, child_id: str) -> SeqAllocation:
        """Copy-on-write fork: ``child_id`` shares *every* block of
        ``parent_id`` (ref-counted, zero copies). The first append that lands
        in a still-shared partial block triggers CoW (``append_token_cow``)."""
        if child_id in self._seqs:
            raise KeyError(f"sequence {child_id} already allocated")
        parent = self._seqs[parent_id]
        for bid in parent.block_ids:
            self._ref[bid] += 1
        alloc = SeqAllocation(block_ids=list(parent.block_ids),
                              num_tokens=parent.num_tokens,
                              shared_prefix_blocks=len(parent.block_ids))
        self._seqs[child_id] = alloc
        return alloc

    def append_token_cow(self, seq_id: str
                         ) -> Tuple[Optional[int], Optional[Tuple[int, int]]]:
        """Account one decoded token with copy-on-write semantics. Returns
        ``(new_block_id | None, copy | None)`` where ``copy = (src, dst)``
        instructs the device pool to clone block ``src`` into ``dst`` before
        the write: the token would have landed in a block another sequence
        still references (a CoW-forked tail), so the writer gets a private
        copy and the sibling keeps the original bytes."""
        alloc = self._seqs[seq_id]
        write_idx = alloc.num_tokens        # token index this append writes
        blk_pos = write_idx // self.block_size
        if blk_pos >= len(alloc.block_ids):     # boundary: fresh private block
            if not self._free:
                raise OutOfBlocks("decode append")
            bid = self._free.pop()
            self._ref[bid] = 1
            alloc.block_ids.append(bid)
            alloc.num_tokens += 1
            return bid, None
        bid = alloc.block_ids[blk_pos]
        if self._ref[bid] > 1:                  # shared partial tail: CoW
            if not self._free:
                raise OutOfBlocks("cow append")
            dst = self._free.pop()
            self._ref[bid] -= 1
            self._ref[dst] = 1
            alloc.block_ids[blk_pos] = dst
            alloc.num_tokens += 1
            return dst, (bid, dst)
        alloc.num_tokens += 1
        return None, None

    def append_token(self, seq_id: str) -> Optional[int]:
        """Account one decoded token; returns a newly allocated block id if a
        block boundary was crossed (or a CoW copy was taken)."""
        bid, _ = self.append_token_cow(seq_id)
        return bid

    def padded_block_table(self, seq_id: str, width: int,
                           pad_id: int) -> List[int]:
        """``seq_id``'s block table padded (or validated) to ``width`` entries
        — the fixed-shape row the paged-attention kernels consume. ``pad_id``
        should be a scratch block no live sequence owns."""
        table = self._seqs[seq_id].block_ids
        if len(table) > width:
            raise ValueError(f"sequence {seq_id} spans {len(table)} blocks"
                             f" > table width {width}")
        return list(table) + [pad_id] * (width - len(table))

    def free(self, seq_id: str) -> None:
        alloc = self._seqs.pop(seq_id, None)
        if alloc is not None:
            for bid in alloc.block_ids:
                self._ref[bid] -= 1
                if self._ref[bid] == 0:
                    del self._ref[bid]
                    key = self._block_keys.pop(bid, None)
                    if key is not None:
                        self._prefix_blocks.pop(key, None)
                    self._free.append(bid)
        self.cancel_prefetch(seq_id)
        host = self._host_seqs.pop(seq_id, None)
        if host is not None:
            self._host_free.extend(host.block_ids)

    # ---------------------------------------------------------------- swapping
    def can_swap_out(self, seq_id: str) -> bool:
        alloc = self._seqs.get(seq_id)
        return (alloc is not None
                and len(alloc.block_ids) <= len(self._host_free))

    def swap_out(self, seq_id: str) -> List[Tuple[int, int]]:
        """Park ``seq_id``'s KV on the host tier. Returns the copy plan
        ``[(device_bid, host_bid), ...]`` in table order — the executor copies
        *every* block (shared prefix blocks included, so the host image is
        self-contained), then this accounting drops one device reference per
        block: blocks siblings still reference stay resident on device and are
        never returned to the free list here."""
        alloc = self._seqs.pop(seq_id)
        need = len(alloc.block_ids)
        if need > len(self._host_free):
            self._seqs[seq_id] = alloc
            raise OutOfBlocks(
                f"swap_out {seq_id}: need {need} host blocks, "
                f"have {len(self._host_free)}")
        plan: List[Tuple[int, int]] = []
        host_ids: List[int] = []
        for bid in alloc.block_ids:
            hid = self._host_free.pop()
            host_ids.append(hid)
            plan.append((bid, hid))
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                del self._ref[bid]
                key = self._block_keys.pop(bid, None)
                if key is not None:
                    self._prefix_blocks.pop(key, None)
                self._free.append(bid)
        self._host_seqs[seq_id] = HostAllocation(
            block_ids=host_ids, num_tokens=alloc.num_tokens)
        return plan

    def can_swap_in(self, seq_id: str) -> bool:
        if seq_id in self._staged:
            return True    # its device blocks are already allocated
        host = self._host_seqs.get(seq_id)
        return host is not None and len(host.block_ids) <= len(self._free)

    # ------------------------------------------------------- swap-in prefetch
    def prefetch_swap_in(self, seq_id: str) -> Optional[List[Tuple[int, int]]]:
        """Stage a swapped sequence's host image into fresh device blocks
        ahead of the swap-in commit. Returns the copy plan
        ``[(host_bid, device_bid), ...]``, or None when the sequence is not on
        the host tier, is already staged, or the pool lacks free blocks (the
        commit then takes the synchronous ``swap_in`` path). The host
        allocation stays authoritative until ``commit_prefetch`` — a cancel
        just returns the fresh blocks."""
        host = self._host_seqs.get(seq_id)
        if host is None or seq_id in self._staged:
            return None
        need = len(host.block_ids)
        if need > len(self._free):
            return None
        fresh = [self._free.pop() for _ in range(need)]
        for bid in fresh:
            self._ref[bid] = 1
        self._staged[seq_id] = fresh
        return list(zip(host.block_ids, fresh))

    def commit_prefetch(self, seq_id: str) -> None:
        """Finish a staged swap-in: the staged blocks become the sequence's
        device allocation and its host blocks are returned to the host free
        list."""
        fresh = self._staged.pop(seq_id)
        host = self._host_seqs.pop(seq_id)
        self._host_free.extend(host.block_ids)
        self._seqs[seq_id] = SeqAllocation(
            block_ids=fresh, num_tokens=host.num_tokens,
            shared_prefix_blocks=0)

    def cancel_prefetch(self, seq_id: str) -> None:
        """Abort a staged swap-in (the request was cancelled between prefetch
        and commit): the staged device blocks return to the free list; the
        host image is untouched — ``free`` reclaims it separately.
        Idempotent."""
        fresh = self._staged.pop(seq_id, None)
        if fresh is None:
            return
        for bid in fresh:
            del self._ref[bid]
            self._free.append(bid)

    def swap_in(self, seq_id: str) -> List[Tuple[int, int]]:
        """Bring a swapped sequence back to device. Returns the copy plan
        ``[(host_bid, device_bid), ...]``. The sequence gets fresh private
        blocks (its former shared-prefix identity was dropped at swap-out —
        resumption never aliases a sibling's pages). A staged sequence
        commits its prefetched blocks instead (the plan's copies already
        happened, but re-copying is harmless)."""
        if seq_id in self._staged:
            plan = list(zip(self._host_seqs[seq_id].block_ids,
                            self._staged[seq_id]))
            self.commit_prefetch(seq_id)
            return plan
        host = self._host_seqs.pop(seq_id)
        need = len(host.block_ids)
        if need > len(self._free):
            self._host_seqs[seq_id] = host
            raise OutOfBlocks(
                f"swap_in {seq_id}: need {need} blocks, "
                f"have {len(self._free)}")
        plan: List[Tuple[int, int]] = []
        fresh: List[int] = []
        for hid in host.block_ids:
            bid = self._free.pop()
            self._ref[bid] = 1
            fresh.append(bid)
            plan.append((hid, bid))
        self._host_free.extend(host.block_ids)
        self._seqs[seq_id] = SeqAllocation(
            block_ids=fresh, num_tokens=host.num_tokens,
            shared_prefix_blocks=0)
        return plan

    # ---------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        in_use = set()
        for alloc in self._seqs.values():
            in_use.update(alloc.block_ids)
        # staged prefetch blocks are device-resident (not free, not yet a
        # sequence allocation) and only ever staged for host-tier sequences
        assert set(self._staged) <= set(self._host_seqs), \
            "prefetch staged for a sequence not on the host tier"
        for blocks in self._staged.values():
            assert not (in_use & set(blocks)), "staged block also allocated"
            in_use.update(blocks)
        free = set(self._free)
        assert not (in_use & free), "block both free and in use"
        assert all(self._ref.get(b, 0) > 0 for b in in_use)
        # exact conservation: every block is either free or referenced by at
        # least one sequence — shared prefix blocks appear once in ``in_use``
        # no matter how many sequences reference them
        assert len(free) + len(in_use) == self.num_blocks, \
            f"{len(free)} free + {len(in_use)} in use != {self.num_blocks}"
        assert len(self._free) == len(free), "duplicate id in free list"
        # host-tier conservation: host blocks are never shared, so the sum of
        # per-sequence host tables plus the host free list is exact
        host_used = [b for a in self._host_seqs.values() for b in a.block_ids]
        host_free = set(self._host_free)
        assert len(set(host_used)) == len(host_used), \
            "host block owned by two sequences"
        assert not (set(host_used) & host_free), "host block free and in use"
        assert len(host_free) + len(host_used) == self.num_host_blocks, \
            (f"{len(host_free)} host free + {len(host_used)} host in use "
             f"!= {self.num_host_blocks}")
        assert len(self._host_free) == len(host_free), \
            "duplicate id in host free list"


class SharedPrefixLedger:
    """Token-granular admission twin of ``BlockManager``'s ref-counted shared
    prefix blocks: schedulers charge the KV cap in *tokens*, so this ledger
    tracks, per block key, how many live requests' charges include that block
    — and exposes ``discount``, the tokens counted more than once. Admission
    subtracts the discount from raw per-request charges, making shared prefix
    blocks count once against ``limits.cap`` exactly as they occupy device
    memory once in the paged ``BlockManager``.

    Because keys are chained hashes, a key's holders all share the entire
    prefix up to that block, and reference counts are non-increasing along any
    request's chain — so the still-shared blocks after any release form a
    leading run and the discount never goes negative.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._ref: Dict[int, int] = {}
        self.discount = 0          # tokens charged more than once (Σ (ref-1)·bs)

    def __len__(self) -> int:
        return len(self._ref)

    def contains(self, key: int) -> bool:
        return self._ref.get(key, 0) > 0

    def shared_tokens(self, keys: Sequence[int]) -> int:
        """Tokens of the leading blocks of ``keys`` already charged by a live
        request — what admitting this chain would add to the discount."""
        n = 0
        for k in keys:
            if self._ref.get(k, 0) > 0:
                n += self.block_size
            else:
                break
        return n

    def acquire(self, keys: Sequence[int]) -> int:
        """Register a charged request's block chain; returns the tokens newly
        discounted (its prefix overlap with already-charged requests)."""
        saved = self.shared_tokens(keys)
        for k in keys:
            self._ref[k] = self._ref.get(k, 0) + 1
        self.discount += saved
        return saved

    def release(self, keys: Sequence[int]) -> None:
        """Drop one charge of ``keys``. Blocks still referenced by siblings
        stay discounted — their tokens remain charged through the survivors'
        raw footprints, so nothing shared is double-freed."""
        for k in keys:
            n = self._ref.get(k, 0) - 1
            if n > 0:
                self._ref[k] = n
                self.discount -= self.block_size
            else:
                self._ref.pop(k, None)

    def check_invariants(self) -> None:
        assert self.discount == sum(
            max(0, n - 1) for n in self._ref.values()) * self.block_size
        assert all(n > 0 for n in self._ref.values())
