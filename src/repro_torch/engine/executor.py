"""Real PyTorch executors: token-by-token execution of scheduler-issued
batches on an actual model, on the device the parameters live on (CUDA, or
the CPU when the caller asked for it).

Two KV backends behind one engine-facing contract (``dispatch`` / ``wait`` —
with ``execute`` as the serial composition — plus ``release_request`` /
``validate_relquery`` / ``prestage`` / ``fitted_model``, the four swap hooks
and ``kv_tokens_resident``):

``RealExecutor`` — the dense baseline. ``max_slots`` decode cache slots of
``max_len`` tokens each; prefill assigns slots one request at a time with
bucketed padding, decode runs one ``decode_step`` over all slots. Kept
bit-identical as the reference the paged backend is pinned against.

``PagedRealExecutor`` — block-paged KV owned by ``BlockManager``: one
``[num_blocks, block_size, heads, dim]`` K/V pool per layer, per-request
block tables, batched multi-request prefill (bucketed on batch and length,
through the ``flash_prefill`` kernel on CUDA) and decode through the
``paged_attention`` kernel on CUDA. On the CPU the same path runs the plain
versions. Prefix-sharing chains map to physically shared (ref-counted) blocks
with copy-on-write on divergence; preemption releases real blocks.

PyTorch runs eagerly, so there is no ahead-of-time compile to keep out of the
samples; what takes its place on CUDA is the kernel build, done in the paged
executor's constructor. KV pools and caches are updated in place. Swapped-out
KV is copied synchronously to host memory.

Both are the calibration source for the linear batch-cost model (paper
Fig. 7): ``fitted_model()`` fits α/β from measured (tokens, duration) /
(reqs, duration) samples.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import latency_model as lm_mod
from repro_torch.core.batch import Batch
from repro_torch.core.relquery import RelQuery, Request
from repro_torch.core.scheduler import BatchResult
from repro_torch.engine.kv_cache import BlockManager, OutOfBlocks
from repro_torch.engine.prefix_cache import PrefixCache, block_hashes
from repro_torch.kernels import build


class RequestCapacityError(ValueError):
    """A request can never fit this executor's per-sequence KV capacity —
    raised at admission (``EngineCore.admit``) instead of overflowing the
    slot buffer / block table mid-flight."""


@dataclass
class InFlight:
    """A dispatched-but-not-consumed batch: the device logits (still being
    computed on a CUDA stream until someone copies them to the host) plus
    the host bookkeeping ``wait`` needs to turn them into a ``BatchResult``.

    Splitting ``execute`` into ``dispatch`` (launch the model, host-side KV
    bookkeeping) and ``wait`` (copy logits to the host, sample, finish
    detection) lets the engine run the *next* scheduling decision while this
    batch is still on the device."""
    batch: Batch
    # dense: [(req, logits)] per completing prefill; paged: [(group, logits)]
    prefill_pending: List
    decode_pending: Optional[object]     # decode-phase logits, or None
    decode_reqs: List[Request]
    decode_rows: List[int]               # dense: logits row per decode req
    utok: int                            # measured uncached prefill tokens
    prefill_issue_s: float               # host issue time
    decode_issue_s: float
    # produced-token count per req_id *as of dispatch* (this batch's token
    # included). The pipelined engine projects placeholder tokens onto
    # ``output_tokens`` while the batch is in flight, so ``wait`` must not
    # re-derive progress from live request state.
    produced: Dict[str, int] = field(default_factory=dict)


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _ExecutorBase:
    """Shared mechanics of the real executors: sampling, finish detection,
    admission-time capacity validation and cost-model calibration."""

    def __init__(self, model, params, *, max_len: int,
                 prefix_cache: Optional[PrefixCache] = None,
                 greedy: bool = True):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_len = max_len
        self.prefix_cache = prefix_cache
        self.greedy = greedy
        self.prefill_samples: List[Tuple[int, float]] = []
        self.decode_samples: List[Tuple[int, float]] = []

    # ------------------------------------------------------------- admission
    def validate_relquery(self, rq: RelQuery) -> None:
        """Reject (at admission) any request whose worst-case prompt+output
        footprint can never fit a sequence's KV capacity."""
        for r in rq.requests:
            need = r.num_prompt_tokens + r.max_output_tokens
            if need > self.max_len:
                raise RequestCapacityError(
                    f"request {r.req_id} of relQuery {rq.rel_id} needs up to "
                    f"{need} KV tokens (prompt {r.num_prompt_tokens} + "
                    f"max_output {r.max_output_tokens}) but this executor's "
                    f"per-sequence capacity is max_len={self.max_len}; "
                    f"shorten the prompt, lower max_output_tokens, or build "
                    f"the executor with a larger max_len")

    def prestage(self, batch: Batch) -> None:
        """Called by the pipelined engine under the previous batch's device
        compute. The JAX executors compile shape buckets here; eager PyTorch
        has nothing to compile, so this does nothing."""

    # ------------------------------------------------------------- shared bits
    def _ints(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _sample(self, logits) -> np.ndarray:
        # torch.argmax takes the first maximum, as jnp.argmax does
        return logits.argmax(-1).cpu().numpy()

    def _is_finish_token(self, r: Request, tok: int, produced: int) -> bool:
        if r.eos_token is not None and tok == r.eos_token:
            return True
        return produced >= r.max_output_tokens

    def _account_prefill(self, r: Request, seq: Sequence[int]) -> int:
        """Prefix-cache stats identical across backends (count then insert,
        in batch order): only the prompt enters the cache."""
        if self.prefix_cache is None:
            return len(seq)
        cached = self.prefix_cache.count_cached(seq)
        self.prefix_cache.insert(r.tokens)
        return len(seq) - cached

    # ------------------------------------------------------------- calibration
    def fitted_model(self):
        return lm_mod.fit(self.prefill_samples, self.decode_samples)


@dataclass
class Slot:
    req: Request
    position: int          # next decode position (== tokens written so far)


class RealExecutor(_ExecutorBase):
    """Dense per-slot KV backend (the bit-identical baseline). The dense
    cache is ``{"k_full", "v_full"}`` of ``[G, 1, max_slots, max_len, KVs,
    hd]``; axis 2 is the slot axis."""

    def __init__(self, model, params, *, max_slots: int = 32, max_len: int = 512,
                 prefix_cache: Optional[PrefixCache] = None, greedy: bool = True):
        super().__init__(model, params, max_len=max_len,
                         prefix_cache=prefix_cache, greedy=greedy)
        self.max_slots = max_slots
        self.cache = model.init_cache(max_slots, max_len, self.device)
        self.slots: List[Optional[Slot]] = [None] * max_slots
        self._slot_of: Dict[str, int] = {}
        # host KV tier: req_id -> (request, slot position, {name: host slice})
        self._host_stash: Dict[str, Tuple[Request, int, Dict[str, torch.Tensor]]] = {}
        # swap-in prefetch: req_id -> device copy of its stash, staged ahead
        # of the commit (the stash itself stays authoritative until commit)
        self._prestaged: Dict[str, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------------ slots
    def _alloc_slot(self, req: Request) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = Slot(req, 0)
                self._slot_of[req.req_id] = i
                return i
        raise RuntimeError("out of decode slots — scheduler exceeded max_num_seqs")

    def _free_slot(self, req_id: str) -> None:
        i = self._slot_of.pop(req_id, None)
        if i is not None:
            self.slots[i] = None

    def release_request(self, req_id: str) -> None:
        """Free executor-side state held for a request (its decode slot
        and/or host-tier stash). Unknown req_ids are a no-op."""
        self._free_slot(req_id)
        self._host_stash.pop(req_id, None)
        self._prestaged.pop(req_id, None)

    # --------------------------------------------------------------- swapping
    def swap_out(self, req_id: str, tokens: int) -> float:
        """Copy ``req_id``'s KV slot to host memory and free the slot.
        Unknown req_ids (already released) are a no-op. Returns the extra
        seconds to charge: 0.0, as the reference does."""
        i = self._slot_of.get(req_id)
        if i is None:
            return 0.0
        slot = self.slots[i]
        stash = {name: c[:, :, i:i + 1].to("cpu", copy=True)
                 for name, c in self.cache.items()}
        self._host_stash[req_id] = (slot.req, slot.position, stash)
        self._free_slot(req_id)
        return 0.0

    def prefetch_swap_in(self, req_id: str, tokens: int) -> float:
        """Stage a stashed request's KV back onto the device ahead of its
        swap-in commit. Unknown/already-staged req_ids are a no-op."""
        entry = self._host_stash.get(req_id)
        if entry is None or req_id in self._prestaged:
            return 0.0
        self._prestaged[req_id] = {n: x.to(self.device)
                                   for n, x in entry[2].items()}
        return 0.0

    def cancel_swap_prefetch(self, req_id: str, tokens: int) -> float:
        """Drop a staged prefetch whose request was cancelled before the
        swap-in commit. Idempotent."""
        self._prestaged.pop(req_id, None)
        return 0.0

    def swap_in(self, req_id: str, tokens: int) -> float:
        """Restore a stashed request into a fresh slot; it resumes decoding
        at its stashed position — no re-prefill. A prefetched request's
        staged device copy is consumed instead of the host stash."""
        entry = self._host_stash.pop(req_id, None)
        if entry is None:
            return 0.0
        req, position, stash = entry
        stash = self._prestaged.pop(req_id, None) or stash
        i = self._alloc_slot(req)
        for name, c in self.cache.items():
            c[:, :, i:i + 1] = stash[name].to(self.device, c.dtype)
        self.slots[i].position = position
        return 0.0

    # ------------------------------------------------------------------ prefill
    def _prefill_issue(self, req: Request) -> Tuple[object, int]:
        """Launch a request's prefill and write its KV into a slot; returns
        (device logits, utok) without sampling. For a preempted request's
        restart the pass recomputes prompt + preserved generation."""
        seq = req.prefill_token_ids()
        n = len(seq)
        utok = self._account_prefill(req, seq)
        # never pad past the slot length — admission guarantees n <= max_len
        bucket = min(_bucket(n), self.max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = seq
        logits, kv = self.model.prefill(
            self.params, self._ints(toks), seq_lens=self._ints(np.array([n], np.int32)),
            max_len=self.max_len)
        slot = self._alloc_slot(req)
        for name, c in self.cache.items():
            c[:, :, slot:slot + 1] = kv[name].to(c.dtype)
        self.slots[slot].position = n
        return logits, utok

    # ------------------------------------------------------------------ decode
    def _decode_issue(self, reqs: List[Request]) -> object:
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        # decode_step writes every row's K/V at positions[i]: occupied
        # off-batch rows point at their own next position with their own
        # last token (an idempotent write whose logits are discarded), never
        # at (token 0, position 0), which would corrupt a live slot.
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i] = s.req.output_tokens[-1] if s.req.output_tokens else 0
                positions[i] = s.position
        for r in reqs:
            i = self._slot_of[r.req_id]
            tokens[i] = r.output_tokens[-1] if r.output_tokens else 0
            positions[i] = self.slots[i].position
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._ints(tokens), self._ints(positions))
        for r in reqs:
            self.slots[self._slot_of[r.req_id]].position += 1
        return logits

    # ------------------------------------------------------------------ engine API
    def dispatch(self, batch: Batch, now: float) -> InFlight:
        """Launch one unified batch without waiting for the device: prefill
        passes write their KV and the decode step advances the slot
        positions, but no logits reach the host. Prefill and decode issue
        times are kept separate for the phase-separated samples."""
        t0 = _time.perf_counter()
        pending = []
        total_utok = 0
        for r in batch.prefill_requests:
            if not batch.completes_prompt(r):
                continue  # chunk not finishing the prompt: accounted only
            logits, utok = self._prefill_issue(r)
            total_utok += utok
            pending.append((r, logits))
        prefill_issue = _time.perf_counter() - t0
        reqs = [r for r in batch.decode_requests if r.req_id in self._slot_of]
        decode_logits, rows, decode_issue = None, [], 0.0
        if reqs:
            t1 = _time.perf_counter()
            decode_logits = self._decode_issue(reqs)
            # capture logits rows now: a prefill request finishing in wait()
            # frees its own slot only, so these stay valid either way
            rows = [self._slot_of[r.req_id] for r in reqs]
            decode_issue = _time.perf_counter() - t1
        produced = {r.req_id: len(r.output_tokens) + 1
                    for r in (*(p[0] for p in pending), *reqs)}
        return InFlight(batch=batch, prefill_pending=pending,
                        decode_pending=decode_logits, decode_reqs=reqs,
                        decode_rows=rows, utok=total_utok,
                        prefill_issue_s=prefill_issue,
                        decode_issue_s=decode_issue, produced=produced)

    def wait(self, inflight: InFlight) -> Tuple[float, BatchResult]:
        """Materialize a dispatched batch: sample every pending logits row
        (the blocking device-to-host copy), detect finishes and free their
        slots. Returns (duration, BatchResult); durations cover issue + wait."""
        outputs: Dict[str, Tuple[int, bool]] = {}
        prefill_dur = inflight.prefill_issue_s
        if inflight.prefill_pending:
            t0 = _time.perf_counter()
            for r, logits in inflight.prefill_pending:
                tok = int(self._sample(logits)[0])
                # a restarted (preempted) request already produced its
                # preserved tokens; this prefill emits the (len + 1)-th
                finished = self._is_finish_token(r, tok,
                                                 inflight.produced[r.req_id])
                outputs[r.req_id] = (tok, finished)
                if finished:
                    self._free_slot(r.req_id)
            prefill_dur += _time.perf_counter() - t0
            self.prefill_samples.append((inflight.utok, prefill_dur))
        decode_dur = inflight.decode_issue_s
        if inflight.decode_pending is not None:
            t1 = _time.perf_counter()
            out = self._sample(inflight.decode_pending)
            for r, row in zip(inflight.decode_reqs, inflight.decode_rows):
                tok = int(out[row])
                finished = self._is_finish_token(r, tok,
                                                 inflight.produced[r.req_id])
                outputs[r.req_id] = (tok, finished)
                if finished:
                    self._free_slot(r.req_id)
            decode_dur += _time.perf_counter() - t1
            self.decode_samples.append((len(inflight.decode_reqs), decode_dur))
        return prefill_dur + decode_dur, BatchResult(outputs)

    def execute(self, batch: Batch, now: float) -> Tuple[float, BatchResult]:
        """Serial composition of the split contract."""
        return self.wait(self.dispatch(batch, now))


class PagedRealExecutor(_ExecutorBase):
    """Block-paged KV backend: ``BlockManager``-owned pools, per-request
    block tables, batched bucketed prefill and paged-attention decode.

    The last pool block (id ``num_blocks``) is a scratch page: pad rows and
    pad table entries route there, so fixed-shape writes never touch live
    blocks. KV demand agrees with the scheduler's token ledger: a request is
    resident from prefill completion to finish/preempt/cancel, shared prefix
    chains (``share_prefix_blocks=True``) are held once and ref-counted, and
    copy-on-write runs if a write lands in a block a sibling still references.

    The device of ``params`` picks the attention: the ``flash_prefill`` and
    ``paged_attention`` kernels on CUDA, the plain dense recipes on the CPU,
    which keep paged and dense decode bit-identical there.
    """

    def __init__(self, model, params, *, num_blocks: int = 1024,
                 block_size: int = 16, max_len: int = 512,
                 prefix_cache: Optional[PrefixCache] = None,
                 greedy: bool = True,
                 share_prefix_blocks: bool = False,
                 num_host_blocks: int = 0):
        if not getattr(model, "supports_paged", lambda: False)():
            raise NotImplementedError(
                f"model {model.cfg.name!r} does not support the paged KV "
                f"backend; use kv_backend='dense'")
        on_cpu = params["embed"].device.type == "cpu"
        if not on_cpu:
            model = model.with_prefill_attn("flash")
        super().__init__(model, params, max_len=max_len,
                         prefix_cache=prefix_cache, greedy=greedy)
        self.attn_impl = "ref" if on_cpu else "kernel"
        if not on_cpu:
            # build time lands here, never in a batch's sample
            build.build()
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.scratch_block = num_blocks          # pools hold one extra page
        self.max_blocks_per_seq = -(-max_len // block_size)
        self.share_prefix_blocks = share_prefix_blocks
        self.num_host_blocks = num_host_blocks
        self.bm = BlockManager(num_blocks, block_size=block_size,
                               num_host_blocks=num_host_blocks)
        self.pools = model.init_paged_pools(num_blocks + 1, block_size,
                                            self.device)
        self._active: Dict[str, Request] = {}
        # host KV tier: req_id -> (request, {"k": blocks, "v": blocks}) with
        # blocks gathered along the pool's block axis in table order
        self._host_stash: Dict[str, Tuple[Request, Dict[str, torch.Tensor]]] = {}
        # swap-in prefetch: req_id -> staged copy plan; the blocks were
        # written at prefetch time, so the commit is pure accounting
        self._staged_swap_in: Dict[str, List[Tuple[int, int]]] = {}
        self.cow_copies = 0
        self.shared_block_hits = 0    # physically shared prefix blocks reused

    # ------------------------------------------------------------- admission
    def validate_relquery(self, rq: RelQuery) -> None:
        """Beyond the per-sequence ``max_len`` bound, a request must also fit
        the *pool*."""
        super().validate_relquery(rq)
        for r in rq.requests:
            need = r.num_prompt_tokens + r.max_output_tokens
            blocks = self.bm.blocks_needed(need)
            if blocks > self.num_blocks:
                raise RequestCapacityError(
                    f"request {r.req_id} of relQuery {rq.rel_id} needs "
                    f"{blocks} KV blocks (footprint {need} tokens / "
                    f"block_size {self.block_size}) but the paged pool holds "
                    f"only num_blocks={self.num_blocks}; grow the pool or "
                    f"shrink the request")

    # ------------------------------------------------------------- bookkeeping
    def release_request(self, req_id: str) -> None:
        """Free the request's blocks (cancellation/preemption/finish):
        siblings still referencing shared prefix blocks keep them alive. A
        swapped request's host blocks and stash go too."""
        known = self._active.pop(req_id, None) is not None
        known = (self._host_stash.pop(req_id, None) is not None) or known
        self._staged_swap_in.pop(req_id, None)
        if known:
            self.bm.free(req_id)   # staged prefetch blocks go back too

    def _write_blocks(self, dst_ids: List[int], data: Dict[str, torch.Tensor]) -> None:
        dst = self._ints(np.asarray(dst_ids, np.int64))
        for name, pool in self.pools.items():
            pool[:, :, dst] = data[name].to(self.device, pool.dtype)

    # --------------------------------------------------------------- swapping
    def swap_out(self, req_id: str, tokens: int) -> float:
        """Copy ``req_id``'s blocks to host memory per the BlockManager's
        copy plan. Every block is gathered (shared prefix blocks included —
        the host image is self-contained) before the manager drops the device
        references. Returns 0.0 extra seconds, as the reference does."""
        r = self._active.pop(req_id, None)
        if r is None:
            return 0.0
        plan = self.bm.swap_out(req_id)        # [(device_bid, host_bid)]
        dev = self._ints(np.asarray([d for d, _ in plan], np.int64))
        data = {name: pool.index_select(2, dev).cpu()
                for name, pool in self.pools.items()}
        self._host_stash[req_id] = (r, data)
        return 0.0

    def prefetch_swap_in(self, req_id: str, tokens: int) -> float:
        """Write a swapped request's host image into freshly allocated device
        blocks ahead of the swap-in commit, which is then pure accounting.
        No-op when the request is unknown, already staged, or the pool lacks
        free blocks (the commit then takes the synchronous path)."""
        entry = self._host_stash.get(req_id)
        if entry is None or req_id in self._staged_swap_in:
            return 0.0
        plan = self.bm.prefetch_swap_in(req_id)
        if plan is None:
            return 0.0
        self._write_blocks([d for _, d in plan], entry[1])
        self._staged_swap_in[req_id] = plan
        return 0.0

    def cancel_swap_prefetch(self, req_id: str, tokens: int) -> float:
        """Return a staged prefetch's device blocks (the request was
        cancelled before commit); freed blocks are rewritten before reuse.
        Idempotent."""
        if self._staged_swap_in.pop(req_id, None) is not None:
            self.bm.cancel_prefetch(req_id)
        return 0.0

    def swap_in(self, req_id: str, tokens: int) -> float:
        """Restore a swapped request into fresh private device blocks and
        resume decode at its stashed context length — no re-prefill."""
        entry = self._host_stash.pop(req_id, None)
        if entry is None:
            return 0.0
        r, data = entry
        if self._staged_swap_in.pop(req_id, None) is not None:
            self.bm.commit_prefetch(req_id)
            self._active[req_id] = r
            return 0.0
        plan = self.bm.swap_in(req_id)         # [(host_bid, device_bid)]
        self._write_blocks([d for _, d in plan], data)
        self._active[req_id] = r
        return 0.0

    def kv_tokens_resident(self) -> int:
        """Per-sequence resident tokens: shared prefix blocks count once per
        referencing sequence (the scheduler's raw optimistic charge)."""
        return self.bm.tokens_in_use()

    def _prompt_keys(self, r: Request) -> Tuple[int, ...]:
        return tuple(block_hashes(r.tokens, self.block_size))

    def _prefill_group_key(self, r: Request) -> int:
        """Block-aligned length bucket a request prefills under (the same
        per-request bucket the dense baseline pads to)."""
        L = min(_bucket(len(r.prefill_token_ids())), self.max_len)
        return -(-L // self.block_size) * self.block_size

    # ------------------------------------------------------------- prefill
    def _prefill_issue_batch(self, reqs: List[Request]) -> Tuple[List, int]:
        """Batched multi-request prefill, bucketed on (batch, length): each
        group runs as one model call followed by one scatter into the pools.
        Returns ([(group requests, device logits)], utok)."""
        seqs = {r.req_id: r.prefill_token_ids() for r in reqs}
        utok = 0
        for r in reqs:                      # accounting in dense batch order
            utok += self._account_prefill(r, seqs[r.req_id])
        bs = self.block_size
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(self._prefill_group_key(r), []).append(r)
        pending: List = []
        for L in sorted(groups):
            grp = groups[L]
            B = _pow2_bucket(len(grp))
            nblk = L // bs
            toks = np.zeros((B, L), np.int32)
            seq_lens = np.ones((B,), np.int32)
            tables = np.full((B, nblk), self.scratch_block, np.int32)
            for i, r in enumerate(grp):
                seq = seqs[r.req_id]
                n = len(seq)
                toks[i, :n] = seq
                seq_lens[i] = n
                keys = self._prompt_keys(r) if self.share_prefix_blocks else ()
                try:
                    alloc = self.bm.allocate(r.req_id, n, prefix_keys=keys)
                    self.shared_block_hits += alloc.shared_prefix_blocks
                except OutOfBlocks as e:
                    raise RuntimeError(
                        f"paged KV pool exhausted during prefill of "
                        f"{r.req_id}: {e} — the scheduler's cap admitted more "
                        f"resident tokens than num_blocks*block_size covers"
                    ) from e
                if keys:
                    self.bm.register_prefix(r.req_id, keys)
                self._active[r.req_id] = r
                row = self.bm.padded_block_table(r.req_id, nblk,
                                                 self.scratch_block)
                # a follower never rewrites pages its leader already owns
                # (the leader may be mid-decode attending them): shared
                # leading pages route to scratch in the follower's scatter
                for j in range(alloc.shared_prefix_blocks):
                    row[j] = self.scratch_block
                tables[i] = row
            logits, caches = self.model.prefill(
                self.params, self._ints(toks), seq_lens=self._ints(seq_lens),
                max_len=L)
            self.pools = self.model.scatter_prefill_pools(
                self.pools, caches, self._ints(tables))
            pending.append((grp, logits))
        return pending, utok

    # ------------------------------------------------------------- decode
    def _copy_block(self, src: int, dst: int) -> None:
        """Device-side CoW: clone page ``src`` into ``dst`` across all layers
        before the diverging write."""
        for pool in self.pools.values():
            pool[:, :, dst] = pool[:, :, src]
        self.cow_copies += 1

    def _decode_issue(self, reqs: List[Request]) -> object:
        positions = []
        for r in reqs:
            pos = self.bm.context_len(r.req_id)
            positions.append(pos)
            try:
                _, cow = self.bm.append_token_cow(r.req_id)
            except OutOfBlocks as e:
                raise RuntimeError(
                    f"paged KV pool exhausted during decode of {r.req_id}: "
                    f"{e}") from e
            if cow is not None:
                self._copy_block(*cow)
        width = max(len(self.bm.block_table(r.req_id)) for r in reqs)
        NB = min(_pow2_bucket(width), self.max_blocks_per_seq)
        NB = max(NB, width)
        B = _pow2_bucket(len(reqs))
        tokens = np.zeros((B,), np.int32)
        pos_arr = np.zeros((B,), np.int32)
        ctx = np.ones((B,), np.int32)      # pad rows attend one scratch token
        tables = np.full((B, NB), self.scratch_block, np.int32)
        for i, (r, pos) in enumerate(zip(reqs, positions)):
            tokens[i] = r.output_tokens[-1] if r.output_tokens else 0
            pos_arr[i] = pos
            ctx[i] = pos + 1
            tables[i] = self.bm.padded_block_table(r.req_id, NB,
                                                   self.scratch_block)
        logits, self.pools = self.model.decode_step_paged(
            self.params, self.pools, self._ints(tokens), self._ints(pos_arr),
            self._ints(tables), self._ints(ctx), attn_impl=self.attn_impl)
        return logits

    # ------------------------------------------------------------- engine API
    def dispatch(self, batch: Batch, now: float) -> InFlight:
        """Launch one unified batch: block allocation, prefill + pool scatter
        and the paged decode step; logits stay on the device until ``wait``.
        Block frees of requests finishing in this batch happen in ``wait``."""
        prefill_reqs = [r for r in batch.prefill_requests
                        if batch.completes_prompt(r)]
        pending: List = []
        utok = 0
        prefill_issue = 0.0
        if prefill_reqs:
            t0 = _time.perf_counter()
            pending, utok = self._prefill_issue_batch(prefill_reqs)
            prefill_issue = _time.perf_counter() - t0
        reqs = [r for r in batch.decode_requests if r.req_id in self._active]
        decode_logits, decode_issue = None, 0.0
        if reqs:
            t1 = _time.perf_counter()
            decode_logits = self._decode_issue(reqs)
            decode_issue = _time.perf_counter() - t1
        produced = {r.req_id: len(r.output_tokens) + 1
                    for r in (*(r for grp, _ in pending for r in grp), *reqs)}
        return InFlight(batch=batch, prefill_pending=pending,
                        decode_pending=decode_logits, decode_reqs=reqs,
                        decode_rows=[], utok=utok,
                        prefill_issue_s=prefill_issue,
                        decode_issue_s=decode_issue, produced=produced)

    def wait(self, inflight: InFlight) -> Tuple[float, BatchResult]:
        """Same phase-separated timing contract as the dense executor:
        sample each prefill group then the decode step, free the blocks of
        anything that finished."""
        outputs: Dict[str, Tuple[int, bool]] = {}
        prefill_dur = inflight.prefill_issue_s
        if inflight.prefill_pending:
            t0 = _time.perf_counter()
            for grp, logits in inflight.prefill_pending:
                out_tokens = self._sample(logits)
                for i, r in enumerate(grp):
                    tok = int(out_tokens[i])
                    finished = self._is_finish_token(r, tok,
                                                     inflight.produced[r.req_id])
                    outputs[r.req_id] = (tok, finished)
                    if finished:
                        self.release_request(r.req_id)
            prefill_dur += _time.perf_counter() - t0
            self.prefill_samples.append((inflight.utok, prefill_dur))
        decode_dur = inflight.decode_issue_s
        if inflight.decode_pending is not None:
            t1 = _time.perf_counter()
            out = self._sample(inflight.decode_pending)
            for i, r in enumerate(inflight.decode_reqs):
                tok = int(out[i])
                finished = self._is_finish_token(r, tok,
                                                 inflight.produced[r.req_id])
                outputs[r.req_id] = (tok, finished)
                if finished:
                    self.release_request(r.req_id)
            decode_dur += _time.perf_counter() - t1
            self.decode_samples.append((len(inflight.decode_reqs), decode_dur))
        return prefill_dur + decode_dur, BatchResult(outputs)

    def execute(self, batch: Batch, now: float) -> Tuple[float, BatchResult]:
        """Serial composition of the split contract."""
        return self.wait(self.dispatch(batch, now))


KV_BACKENDS = ("dense", "paged")


def make_real_executor(kv_backend: str, model, params, *, max_slots: int = 32,
                       max_len: int = 512,
                       prefix_cache: Optional[PrefixCache] = None,
                       num_blocks: Optional[int] = None, block_size: int = 16,
                       share_prefix_blocks: bool = False,
                       num_host_blocks: int = 0, **kw):
    """Build a real executor by backend name. ``num_blocks`` defaults to the
    dense layout's physical capacity (max_slots × max_len worth of tokens) so
    switching backends never shrinks device KV. ``num_host_blocks`` sizes the
    paged backend's host swap tier."""
    if kv_backend == "dense":
        return RealExecutor(model, params, max_slots=max_slots,
                            max_len=max_len, prefix_cache=prefix_cache, **kw)
    if kv_backend == "paged":
        if num_blocks is None:
            num_blocks = -(-max_slots * max_len // block_size)
        return PagedRealExecutor(model, params, num_blocks=num_blocks,
                                 block_size=block_size, max_len=max_len,
                                 prefix_cache=prefix_cache,
                                 share_prefix_blocks=share_prefix_blocks,
                                 num_host_blocks=num_host_blocks, **kw)
    raise ValueError(f"unknown kv_backend {kv_backend!r}; expected one of "
                     f"{KV_BACKENDS}")
