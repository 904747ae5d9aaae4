"""Real PyTorch executors: token-by-token execution of scheduler-issued
batches on an actual model, on the device the parameters live on (CUDA, or
the CPU when the caller asked for it).

Two KV backends behind one engine-facing contract (``dispatch`` / ``wait`` —
with ``execute`` as the serial composition — plus ``release_request`` /
``validate_relquery`` / ``prestage`` / ``fitted_model``, the four swap hooks
and ``kv_tokens_resident``):

``RealExecutor`` — the dense baseline, for every decoder-only family:
``max_slots`` decode cache slots (``max_len`` tokens each for attention, one
recurrent state each for RWKV6 and hymba's Mamba branch); prefill assigns
slots one request at a time with bucketed padding, decode runs one
``decode_step`` over all slots. Kept bit-identical as the reference the
paged backend is pinned against.

``PagedRealExecutor`` — block-paged KV owned by ``BlockManager``: one
``[num_blocks, block_size, heads, dim]`` K/V pool per layer, per-request
block tables, batched multi-request prefill (bucketed on batch and length,
through the ``flash_prefill`` kernel on CUDA) and decode through the
``paged_attention`` kernel on CUDA. On the CPU the same path runs the plain
versions. Prefix-sharing chains map to physically shared (ref-counted) blocks
with copy-on-write on divergence; preemption releases real blocks.

Every prefill and decode runs as one step per shape bucket, as the
reference runs one compiled executable per bucket (``_aot``,
``repro/engine/executor.py:128-138``): on CUDA a CUDA graph captured at the
bucket's first use or in ``prestage`` (``engine/graphs.py``), replayed after
one copy of the step's inputs; on the CPU the same bucket bookkeeping around
eager calls. The buckets' keys are the reference's: the dense executor's
``_prefill_fn`` by length and one ``_decode_fn``, the paged executor's
``_prefill_fn`` and ``_scatter_fn`` by (batch, length) and ``_decode_fn`` by
(batch, blocks). Capture seconds are kept out of the samples, as the
reference keeps its compile seconds out; ``prestage``'s are counted apart in
``prestage_compile_s``. A failed capture raises; ``eager=True`` (an argument
of the constructors only) runs eager steps on CUDA, to hold the graphs
against. The build of the model's kernels happens in the constructors. KV
pools and caches are updated in place and never move: the graphs write them
where they were captured. The paged executor's copy-on-write is one step
too, the reference's ``_copy_fn``.

Swaps do not block the host, as the reference's ``copy_to_host_async`` does
not (``repro/engine/executor.py:227-316``). On CUDA ``swap_out`` gathers the
request's KV on the compute stream (before this tick's batch, which may
write the freed slot or blocks), then a copy stream of the executor's copies
the gather into pinned host memory and returns; ``wait()`` finishes the
copies (``_materialize_host_stash``) after the batch's sampling. A swap-in
or prefetch issued before that takes the device gather itself. A prefetch
copies from the pinned stash on the copy stream, and the compute stream
waits on that copy's event before the first step that reads it. No swap
hook synchronises with the device. So the host no longer waits for a
copy; on the card the copies ran in the host's gap before a batch's
replay, not under its kernels (PERF.md §5). A new executor's first
swap-outs still pay for the pinned memory they allocate. On the CPU the
same bookkeeping runs around plain copies.

With a ``Tracer`` set as ``tracer`` (``engine/trace.py``; None by
default) both executors record each step's ``step.load`` and
``step.replay`` spans, a ``capture`` span for a step made at first use, and
one ``sample`` span per sampled phase (prefill group or request, decode);
on CUDA one pair of CUDA events around each step call, from before its load
to after its outputs' clone, whose milliseconds ``wait`` reads after its
samples and notes on the batch's tick per phase (``device_prefill_ms``,
``device_decode_ms``; a copy-on-write counts to the decode), beside the
measured ``uncached_tokens``. The paged executor also records ``dispatch``
(with ``prefill.prep``, ``decode.prep`` and ``cow`` in it) and ``wait``
(with ``finish`` and ``stash``).

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
from repro_torch.engine import graphs, trace
from repro_torch.engine.kv_cache import BlockManager, OutOfBlocks
from repro_torch.engine.prefix_cache import PrefixCache, block_hashes
from repro_torch.kernels import build, paged_attention


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
    # traced on CUDA: (phase, start event, end event) of each step call
    timed: Optional[List] = None


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


def _refuse_encoder_decoder(model) -> None:
    """No engine path serves an encoder-decoder model, as in the reference,
    whose executors would call its prefill without the encoder frames it
    needs."""
    if model.cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{model.cfg.name} is an encoder-decoder model: no engine path "
            f"serves it (its prefill needs encoder frames)")


class _ExecutorBase:
    """Shared mechanics of the real executors: sampling, finish detection,
    admission-time capacity validation, cost-model calibration and the
    capture of each bucket's step."""

    def __init__(self, model, params, *, max_len: int,
                 prefix_cache: Optional[PrefixCache] = None,
                 greedy: bool = True, eager: bool = False):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_len = max_len
        self.prefix_cache = prefix_cache
        self.greedy = greedy
        self.prefill_samples: List[Tuple[int, float]] = []
        self.decode_samples: List[Tuple[int, float]] = []
        # one private memory pool and one capture stream for every graph of
        # this executor; none on the CPU or when the caller asked for eager
        graphed = self.device.type == "cuda" and not eager
        self._pool = torch.cuda.graph_pool_handle() if graphed else None
        self._stream = torch.cuda.Stream(self.device) if graphed else None
        self.capture_s = 0.0          # every capture, prestage's included
        # capture seconds spent pre-staging shape buckets during another
        # batch's device compute (never charged to any batch duration)
        self.prestage_compile_s = 0.0
        self._compile_s = 0.0         # capture time to subtract from a phase
        # the host KV tier's copies run on this stream (none on the CPU)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # swap-outs whose copy to host memory ``wait`` has not finished:
        # req_id -> (the device gather, the copy's event; None on the CPU)
        self._pending_host: Dict[str, Tuple[Dict[str, torch.Tensor],
                                            Optional[torch.cuda.Event]]] = {}
        self.tracer: Optional[trace.Tracer] = None
        self._timed: List = []        # this dispatch's timed steps

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

    # ------------------------------------------------------------- steps
    def _capture(self, fn, init, state) -> Tuple[graphs.Step, float]:
        """One bucket's step (``graphs.capture``) and its seconds. A captured
        step must return the executor's own ``state`` tensors: it writes
        them in place, where every replay writes them again."""
        step, dt = graphs.capture(fn, init, self.device,
                                  pool=self._pool, stream=self._stream)
        if step.graph is not None and any(
                step.outputs[1][name] is not x for name, x in state.items()):
            raise RuntimeError("a captured step returned state tensors other "
                               "than the executor's own")
        self.capture_s += dt
        return step, dt

    def _first_use(self, make, *key) -> graphs.Step:
        """A bucket's step made at its first use, its seconds kept out of
        the phase's sample."""
        with trace.span(self.tracer, "capture", key=key):
            step, dt = make(*key)
        self._compile_s += dt
        return step

    def _run_step(self, step: graphs.Step, arrays: Sequence, phase: str):
        """``step(*arrays)``; traced, in its spans and, on CUDA, between two
        timed events kept for ``wait``."""
        tr = self.tracer
        if tr is None:
            return step(*arrays)
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with tr.span("step.load"):
            step.load(arrays)
        with tr.span("step.replay"):
            out = step.run()
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._timed.append((phase, start, end))
        return out

    def _take_timed(self) -> Optional[List]:
        timed = self._timed
        if not timed:
            return None
        self._timed = []
        return timed

    def _note_device_ms(self, inflight: InFlight) -> None:
        """Onto the batch's tick: the measured uncached prefill tokens and
        each phase's device milliseconds from its steps' events (None where
        no step of the phase was timed: the CPU, or a phase the batch
        lacks). Called after the samples, which waited for the events."""
        if self.tracer is None:
            return
        ms = {"prefill": None, "decode": None}
        for phase, start, end in inflight.timed or ():
            ms[phase] = (ms[phase] or 0.0) + start.elapsed_time(end)
        self.tracer.note(uncached_tokens=inflight.utok,
                         device_prefill_ms=ms["prefill"],
                         device_decode_ms=ms["decode"])

    def _steps(self) -> List[graphs.Step]:
        raise NotImplementedError

    @property
    def num_graphs(self) -> int:
        """CUDA graphs captured (0 for eager steps)."""
        return sum(s.graph is not None for s in self._steps())

    @property
    def prefill_calls(self) -> int:
        """Prefill steps served (one per model call)."""
        return sum(s.calls for s in self._prefill_fn.values())

    def pool_bytes(self) -> Optional[int]:
        """Device bytes held by this executor's graph pool (None: eager, or
        not told by the allocator)."""
        return None if self._pool is None else graphs.pool_bytes(self._pool)

    # ------------------------------------------------------------- host tier
    def _compute(self) -> torch.cuda.Stream:
        return torch.cuda.current_stream(self.device)

    def _on_copy_stream(self, write) -> torch.cuda.Event:
        """Run ``write()`` on the copy stream after all the compute stream's
        work so far; returns the event the compute stream waits on
        (``_settle``) before it reads what was written."""
        copy = self._copy_stream
        copy.wait_stream(self._compute())
        with torch.cuda.stream(copy):
            write()
        return copy.record_event()

    def _to_host(self, req_id: str, gathered: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Start copying ``gathered`` (a swap-out's KV, just gathered on the
        compute stream) to host memory and put the request on
        ``_pending_host``; returns the host tensors. On CUDA the copy runs on
        the copy stream into pinned memory, after the gather; on the CPU the
        gather is the host copy."""
        if self._copy_stream is None:
            self._pending_host[req_id] = (gathered, None)
            return gathered
        host = {name: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for name, x in gathered.items()}

        def write():
            for name, x in gathered.items():
                x.record_stream(self._copy_stream)
                host[name].copy_(x, non_blocking=True)

        self._pending_host[req_id] = (gathered, self._on_copy_stream(write))
        return host

    def _to_device(self, host: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """Device copies of a stash's host tensors, written on the copy
        stream, and the event the compute stream waits on before it reads
        them (``_settle``); the host tensors themselves on the CPU. The
        device tensors come from the compute stream's memory, which the
        swap-out's gather of the same size left cached."""
        if self._copy_stream is None:
            return host, None
        dev = {name: torch.empty(h.shape, dtype=h.dtype, device=self.device)
               for name, h in host.items()}

        def write():
            for name, h in host.items():
                dev[name].record_stream(self._copy_stream)
                dev[name].copy_(h, non_blocking=True)

        return dev, self._on_copy_stream(write)

    def _settle(self, event: Optional[torch.cuda.Event]) -> None:
        """Order the compute stream after a copy-stream write (its event)."""
        if event is not None:
            self._compute().wait_event(event)

    def _materialize_host_stash(self) -> None:
        """Finish the pending copies to host memory (from ``wait``, after
        the batch's own sampling): wait for each copy's event and drop its
        device gather. A request released (a cancel) or swapped back in
        since is skipped, as in the reference."""
        for req_id, (_, event) in self._pending_host.items():
            if req_id in self._host_stash and event is not None:
                event.synchronize()
        self._pending_host.clear()

    # ------------------------------------------------------------- shared bits
    def _ints(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":   # no stream sync for a pinned source
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

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
    """Dense per-slot cache backend (the bit-identical baseline), for any
    model family. The cache is the model's ``init_cache(max_slots, max_len)``
    (``k_full``/``v_full [G, n_full, slots, max_len, KVs, hd]`` for global
    attention layers, the window rings ``k_win``/``v_win`` for gemma3's
    local ones, ``state``/``tm_shift``/``cm_shift`` with slots on axis 1 for
    RWKV6); the model's ``cache_slot_axes()`` names each entry's slot axis. The slot axis
    is never guessed from the shapes, as the reference's ``_slot_axis`` does
    (``repro/engine/executor.py:218-225``): with ``max_slots`` equal to the
    layer count that search takes the layer axis of a recurrent state."""

    def __init__(self, model, params, *, max_slots: int = 32, max_len: int = 512,
                 prefix_cache: Optional[PrefixCache] = None, greedy: bool = True,
                 eager: bool = False):
        _refuse_encoder_decoder(model)
        super().__init__(model, params, max_len=max_len,
                         prefix_cache=prefix_cache, greedy=greedy, eager=eager)
        self.max_slots = max_slots
        self.cache = model.init_cache(max_slots, max_len, self.device)
        self.slot_axes: Dict[str, int] = model.cache_slot_axes()
        if self.device.type != "cpu":
            # build time lands here, never in a batch's sample
            build.build(model.KERNELS)
        self._prefill_fn: Dict[int, graphs.Step] = {}
        self._decode_fn = self._capture_decode()
        self.slots: List[Optional[Slot]] = [None] * max_slots
        self._slot_of: Dict[str, int] = {}
        # host KV tier: req_id -> (request, slot position, {name: host slice})
        self._host_stash: Dict[str, Tuple[Request, int, Dict[str, torch.Tensor]]] = {}
        # swap-in prefetch: req_id -> (device copy of its stash, staged ahead
        # of the commit, and the copy's event); the stash itself stays
        # authoritative until commit
        self._prestaged: Dict[str, Tuple[Dict[str, torch.Tensor],
                                         Optional[torch.cuda.Event]]] = {}

    def _steps(self) -> List[graphs.Step]:
        return [*self._prefill_fn.values(), self._decode_fn]

    def _capture_decode(self) -> graphs.Step:
        """The decode step over all ``max_slots`` rows, captured while no
        slot is live: its warm-up writes every row's K/V at position 0 and
        advances every recurrent state. ``init_cache`` makes every entry
        zeros, so zeroing the cache afterwards leaves it as it was made."""
        model, params, cache = self.model, self.params, self.cache

        def decode(tokens, positions):
            return model.decode_step(params, cache, tokens, positions)

        n = self.max_slots
        zeros = np.zeros((n,), np.int32)
        step, _ = self._capture(decode, [zeros, zeros], cache)
        for c in cache.values():
            c.zero_()
        return step

    def _prefill_step(self, bucket: int) -> Tuple[graphs.Step, float]:
        """The prefill step of one length bucket: a single sequence, whose
        cache (the step's output) ``_prefill_issue`` copies into a slot."""
        model, params, max_len = self.model, self.params, self.max_len

        def prefill(toks, seq_lens):
            return model.prefill(params, toks, seq_lens=seq_lens,
                                 max_len=max_len)

        return self._capture(prefill, [np.zeros((1, bucket), np.int32),
                                       np.ones((1,), np.int32)], {})

    # ------------------------------------------------------------------ slots
    def _slot_view(self, name: str, i: int) -> torch.Tensor:
        """Slot ``i`` of cache entry ``name``, as a view that keeps the slot
        axis (size 1)."""
        return self.cache[name].narrow(self.slot_axes[name], i, 1)

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
        """Stash ``req_id``'s KV slot in host memory and free the slot: the
        copy is issued here and finished by the next ``wait()``.
        Unknown req_ids (already released) are a no-op. Returns the extra
        seconds to charge: 0.0, as the reference does."""
        i = self._slot_of.get(req_id)
        if i is None:
            return 0.0
        slot = self.slots[i]
        gathered = {name: self._slot_view(name, i).clone(
                        memory_format=torch.contiguous_format)
                    for name in self.cache}
        self._host_stash[req_id] = (slot.req, slot.position,
                                    self._to_host(req_id, gathered))
        self._free_slot(req_id)
        return 0.0

    def prefetch_swap_in(self, req_id: str, tokens: int) -> float:
        """Stage a stashed request's KV back onto the device ahead of its
        swap-in commit: a copy on the copy stream, or the device gather of a
        swap-out not yet finished. Unknown/already-staged req_ids are a
        no-op."""
        entry = self._host_stash.get(req_id)
        if entry is None or req_id in self._prestaged:
            return 0.0
        pending = self._pending_host.get(req_id)
        self._prestaged[req_id] = ((pending[0], None) if pending is not None
                                   else self._to_device(entry[2]))
        return 0.0

    def cancel_swap_prefetch(self, req_id: str, tokens: int) -> float:
        """Drop a staged prefetch whose request was cancelled before the
        swap-in commit. Idempotent."""
        self._prestaged.pop(req_id, None)
        return 0.0

    def swap_in(self, req_id: str, tokens: int) -> float:
        """Restore a stashed request into a fresh slot; it resumes decoding
        at its stashed position — no re-prefill. A prefetched request's
        staged device copy is consumed instead of the host stash, and so is
        the device gather of a swap-out not yet finished; otherwise the slot
        is written from pinned memory on the compute stream."""
        entry = self._host_stash.pop(req_id, None)
        if entry is None:
            return 0.0
        req, position, stash = entry
        staged = self._prestaged.pop(req_id, None)
        pending = self._pending_host.get(req_id)
        if staged is not None:
            stash, event = staged
            self._settle(event)
        elif pending is not None:
            stash = pending[0]
        i = self._alloc_slot(req)
        for name in self.cache:
            self._slot_view(name, i).copy_(stash[name], non_blocking=True)
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
        if bucket not in self._prefill_fn:
            self._prefill_fn[bucket] = self._first_use(self._prefill_step, bucket)
        logits, kv = self._run_step(self._prefill_fn[bucket],
                                    (toks, np.array([n], np.int32)), "prefill")
        # the slot differs from call to call: this copy stays outside
        slot = self._alloc_slot(req)
        for name in self.cache:
            self._slot_view(name, slot).copy_(kv[name])
        self.slots[slot].position = n
        return logits, utok

    def prestage(self, batch: Batch) -> None:
        """Capture the prefill buckets ``batch`` will need, as the reference
        compiles them: called by the pipelined engine while the previous
        batch runs on the device. The decode step was captured with the
        executor."""
        for r in batch.prefill_requests:
            if not batch.completes_prompt(r):
                continue
            bucket = min(_bucket(len(r.prefill_token_ids())), self.max_len)
            if bucket in self._prefill_fn:
                continue
            self._prefill_fn[bucket], dt = self._prefill_step(bucket)
            self.prestage_compile_s += dt

    # ------------------------------------------------------------------ decode
    def _decode_issue(self, reqs: List[Request]) -> object:
        """One ``decode_step`` over all ``max_slots`` rows.

        For attention, occupied rows that are not in ``reqs`` (a request
        prefilled in this same batch) point at their own next position with
        their own last token: ``decode_step`` writes every row's K/V at
        ``positions[i]``, and that write is idempotent (the row's own next
        decode rewrites it before any read), never at (token 0, position 0),
        which would corrupt a live slot.

        For a recurrent cache (``model.RECURRENT_CACHE``) no such write is
        harmless, so those rows' cache slices are copied before the step and
        written back after it. Here the port departs from the reference
        (``repro/engine/executor.py:393-400``), which lets them advance: it
        folds a spurious step into the fresh request's state, and whether
        that happens depends on whether the tick also decoded, i.e. on
        measured timing. The port keeps every row exact, so its streams do
        not depend on batch composition."""
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i] = s.req.output_tokens[-1] if s.req.output_tokens else 0
                positions[i] = s.position
        for r in reqs:
            i = self._slot_of[r.req_id]
            tokens[i] = r.output_tokens[-1] if r.output_tokens else 0
            positions[i] = self.slots[i].position
        off = []
        if self.model.RECURRENT_CACHE:
            in_batch = {self._slot_of[r.req_id] for r in reqs}
            off = [i for i, s in enumerate(self.slots)
                   if s is not None and i not in in_batch]
        if off:
            rows = self._ints(np.asarray(off, np.int64))
            kept = {name: c.index_select(self.slot_axes[name], rows)
                    for name, c in self.cache.items()}
        logits, _ = self._run_step(self._decode_fn, (tokens, positions), "decode")
        if off:
            for name, c in self.cache.items():
                c.index_copy_(self.slot_axes[name], rows, kept[name])
        for r in reqs:
            self.slots[self._slot_of[r.req_id]].position += 1
        return logits

    # ------------------------------------------------------------------ engine API
    def dispatch(self, batch: Batch, now: float) -> InFlight:
        """Launch one unified batch without waiting for the device: prefill
        passes write their KV and the decode step advances the slot
        positions, but no logits reach the host. Prefill and decode issue
        times are kept separate for the phase-separated samples, capture
        seconds taken out of both."""
        self._compile_s = 0.0
        t0 = _time.perf_counter()
        pending = []
        total_utok = 0
        for r in batch.prefill_requests:
            if not batch.completes_prompt(r):
                continue  # chunk not finishing the prompt: accounted only
            logits, utok = self._prefill_issue(r)
            total_utok += utok
            pending.append((r, logits))
        prefill_issue = max(0.0, _time.perf_counter() - t0 - self._compile_s)
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
                        decode_issue_s=decode_issue, produced=produced,
                        timed=self._take_timed())

    def wait(self, inflight: InFlight) -> Tuple[float, BatchResult]:
        """Materialize a dispatched batch: sample every pending logits row
        (the blocking device-to-host copy), detect finishes and free their
        slots. Returns (duration, BatchResult); durations cover issue + wait."""
        outputs: Dict[str, Tuple[int, bool]] = {}
        prefill_dur = inflight.prefill_issue_s
        if inflight.prefill_pending:
            t0 = _time.perf_counter()
            for r, logits in inflight.prefill_pending:
                with trace.span(self.tracer, "sample", phase="prefill"):
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
            with trace.span(self.tracer, "sample", phase="decode"):
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
        self._materialize_host_stash()
        self._note_device_ms(inflight)
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
                 num_host_blocks: int = 0, eager: bool = False):
        _refuse_encoder_decoder(model)
        if not getattr(model, "supports_paged", lambda: False)():
            raise NotImplementedError(
                f"model {model.cfg.name!r} does not support the paged KV "
                f"backend; use kv_backend='dense'")
        on_cpu = params["embed"].device.type == "cpu"
        if not on_cpu:
            model = model.with_prefill_attn("flash")
        super().__init__(model, params, max_len=max_len,
                         prefix_cache=prefix_cache, greedy=greedy, eager=eager)
        self.attn_impl = "ref" if on_cpu else "kernel"
        if not on_cpu:
            # build time lands here, never in a batch's sample
            build.build(model.KERNELS)
            # a captured decode keeps the counters' address: size them now
            # for the widest decode this pool admits (each decoding
            # sequence holds a private block after its copy-on-write)
            paged_attention.arrival_counters(
                self.device, _pow2_bucket(num_blocks) * model.cache_heads)
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
        # swap-in prefetch: req_id -> (staged copy plan, the copy's event);
        # the blocks were written at prefetch time, so the commit is
        # accounting and one stream wait
        self._staged_swap_in: Dict[str, Tuple[List[Tuple[int, int]],
                                              Optional[torch.cuda.Event]]] = {}
        # one step per (B, L) covers the prefill and its scatter into the
        # pools; _scatter_fn holds the keys whose scatter has run, which the
        # reference compiles at first dispatch (its prestage compiles only
        # the prefill)
        self._prefill_fn: Dict[Tuple[int, int], graphs.Step] = {}
        self._scatter_fn: Dict[Tuple[int, int], graphs.Step] = {}
        self._decode_fn: Dict[Tuple[int, int], graphs.Step] = {}
        self._copy_fn: Optional[graphs.Step] = None    # copy-on-write
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
        self._unstage(req_id)
        if known:
            self.bm.free(req_id)   # staged prefetch blocks go back too

    def _unstage(self, req_id: str) -> bool:
        """Drop a staged prefetch; the compute stream waits for its copy,
        so nothing it runs later (a write into the blocks, once freed, or a
        decode reading them) overtakes the copy. False if none was staged."""
        staged = self._staged_swap_in.pop(req_id, None)
        if staged is None:
            return False
        self._settle(staged[1])
        return True

    def _write_blocks(self, dst_ids: List[int], data: Dict[str, torch.Tensor]) -> None:
        """Write ``data`` (blocks gathered along the pools' block axis, on
        the device or in pinned host memory) into blocks ``dst_ids``, on the
        current stream."""
        dst = self._ints(np.asarray(dst_ids, np.int64))
        for name, pool in self.pools.items():
            pool.index_copy_(2, dst, data[name].to(self.device,
                                                    non_blocking=True))

    # --------------------------------------------------------------- swapping
    def swap_out(self, req_id: str, tokens: int) -> float:
        """Move ``req_id``'s blocks to host memory per the BlockManager's
        copy plan. Every block is gathered (shared prefix blocks included —
        the host image is self-contained) on the compute stream, before this
        tick's batch may write the freed blocks; the copy to host memory is
        issued here and finished by the next ``wait()``. Returns 0.0 extra
        seconds, as the reference does."""
        r = self._active.pop(req_id, None)
        if r is None:
            return 0.0
        plan = self.bm.swap_out(req_id)        # [(device_bid, host_bid)]
        dev = self._ints(np.asarray([d for d, _ in plan], np.int64))
        gathered = {name: pool.index_select(2, dev)
                    for name, pool in self.pools.items()}
        self._host_stash[req_id] = (r, self._to_host(req_id, gathered))
        return 0.0

    def prefetch_swap_in(self, req_id: str, tokens: int) -> float:
        """Write a swapped request's host image into freshly allocated device
        blocks ahead of the swap-in commit: on the copy stream from the
        pinned stash, or on the compute stream from the device gather of a
        swap-out not yet finished. No batch reads those blocks before the
        commit, which waits for the copy. No-op when the request is unknown,
        already staged, or the pool lacks free blocks (the commit then
        writes the blocks itself)."""
        entry = self._host_stash.get(req_id)
        if entry is None or req_id in self._staged_swap_in:
            return 0.0
        plan = self.bm.prefetch_swap_in(req_id)
        if plan is None:
            return 0.0
        dst = [d for _, d in plan]
        pending = self._pending_host.get(req_id)
        event = None
        if pending is not None or self._copy_stream is None:
            self._write_blocks(dst, entry[1] if pending is None else pending[0])
        else:
            # on the copy stream, after the compute stream's work so far:
            # the fresh blocks may be ones this tick's swap-outs still read
            staged, _ = self._to_device(entry[1])
            event = self._on_copy_stream(lambda: self._write_blocks(dst, staged))
        self._staged_swap_in[req_id] = (plan, event)
        return 0.0

    def cancel_swap_prefetch(self, req_id: str, tokens: int) -> float:
        """Return a staged prefetch's device blocks (the request was
        cancelled before commit); freed blocks are rewritten before reuse.
        Idempotent."""
        if self._unstage(req_id):
            self.bm.cancel_prefetch(req_id)
        return 0.0

    def swap_in(self, req_id: str, tokens: int) -> float:
        """Restore a swapped request into fresh private device blocks and
        resume decode at its stashed context length — no re-prefill. The
        blocks are written from the device gather of a swap-out not yet
        finished, else from pinned memory on the compute stream."""
        entry = self._host_stash.pop(req_id, None)
        if entry is None:
            return 0.0
        r, data = entry
        if self._unstage(req_id):
            self.bm.commit_prefetch(req_id)
            self._active[req_id] = r
            return 0.0
        plan = self.bm.swap_in(req_id)         # [(host_bid, device_bid)]
        pending = self._pending_host.get(req_id)
        self._write_blocks([d for _, d in plan],
                           data if pending is None else pending[0])
        self._active[req_id] = r
        return 0.0

    def kv_tokens_resident(self) -> int:
        """Per-sequence resident tokens: shared prefix blocks count once per
        referencing sequence (the scheduler's raw optimistic charge)."""
        return self.bm.tokens_in_use()

    def _prompt_keys(self, r: Request) -> Tuple[int, ...]:
        return tuple(block_hashes(r.tokens, self.block_size))

    # ------------------------------------------------------------- steps
    def _steps(self) -> List[graphs.Step]:
        cow = [] if self._copy_fn is None else [self._copy_fn]
        return [*self._prefill_fn.values(), *self._decode_fn.values(), *cow]

    def _prefill_step(self, B: int, L: int) -> Tuple[graphs.Step, float]:
        """Prefill of a (B, L) group and its scatter into the pools. Its
        warm-up routes every row and table entry to the scratch block, so it
        writes only the scratch page, even with a batch in flight."""
        model, params, pools = self.model, self.params, self.pools

        def prefill(toks, seq_lens, tables):
            logits, caches = model.prefill(params, toks, seq_lens=seq_lens,
                                           max_len=L)
            return logits, model.scatter_prefill_pools(pools, caches, tables)

        nblk = L // self.block_size
        return self._capture(
            prefill, [np.zeros((B, L), np.int32), np.ones((B,), np.int32),
                      np.full((B, nblk), self.scratch_block, np.int32)], pools)

    def _decode_step(self, B: int, NB: int) -> Tuple[graphs.Step, float]:
        """The paged decode step of a (B, NB) bucket; its warm-up writes
        position 0 of the scratch block only."""
        model, params, pools = self.model, self.params, self.pools
        attn_impl = self.attn_impl

        def decode(tokens, positions, tables, ctx):
            return model.decode_step_paged(params, pools, tokens, positions,
                                           tables, ctx, attn_impl=attn_impl)

        zeros = np.zeros((B,), np.int32)
        return self._capture(
            decode, [zeros, zeros, np.full((B, NB), self.scratch_block, np.int32),
                     np.ones((B,), np.int32)], pools)

    def prestage(self, batch: Batch) -> None:
        """Capture the (batch, length) prefill buckets ``batch`` will group
        into, as the reference compiles them: run by the pipelined engine
        under the previous batch's device compute. Decode steps are captured
        at first use, as the reference compiles them."""
        groups: Dict[int, int] = {}
        for r in batch.prefill_requests:
            if batch.completes_prompt(r):
                L = self._prefill_group_key(r)
                groups[L] = groups.get(L, 0) + 1
        for L, n in sorted(groups.items()):
            key = (_pow2_bucket(n), L)
            if key in self._prefill_fn:
                continue
            self._prefill_fn[key], dt = self._prefill_step(*key)
            self.prestage_compile_s += dt

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
        with trace.span(self.tracer, "prefill.prep"):
            seqs = {r.req_id: r.prefill_token_ids() for r in reqs}
            utok = 0
            for r in reqs:                      # accounting in dense batch order
                utok += self._account_prefill(r, seqs[r.req_id])
            groups: Dict[int, List[Request]] = {}
            for r in reqs:
                groups.setdefault(self._prefill_group_key(r), []).append(r)
        pending: List = []
        for L in sorted(groups):
            grp = groups[L]
            with trace.span(self.tracer, "prefill.prep"):
                inputs = self._prefill_inputs(grp, L, seqs)
            key = (_pow2_bucket(len(grp)), L)
            if key not in self._prefill_fn:
                self._prefill_fn[key] = self._first_use(self._prefill_step, *key)
            self._scatter_fn.setdefault(key, self._prefill_fn[key])
            logits, _ = self._run_step(self._prefill_fn[key], inputs, "prefill")
            pending.append((grp, logits))
        return pending, utok

    def _prefill_inputs(self, grp: List[Request], L: int,
                        seqs: Dict[str, List[int]]) -> Tuple[np.ndarray, ...]:
        """A prefill group's blocks, allocated, and its step's inputs:
        tokens, lengths and block tables, padded to the (batch, L)
        bucket."""
        B = _pow2_bucket(len(grp))
        nblk = L // self.block_size
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
        return toks, seq_lens, tables

    # ------------------------------------------------------------- decode
    def _copy_step(self) -> Tuple[graphs.Step, float]:
        """The copy-on-write step over an int32 ``(src, dst)``: clone page
        ``src`` into ``dst`` across all layers, in place. Its warm-up copies
        the scratch block onto itself."""
        pools = self.pools

        def copy(blocks):
            idx = blocks.long()
            for pool in pools.values():
                pool.index_copy_(2, idx[1:], pool.index_select(2, idx[:1]))
            return (), pools

        s = self.scratch_block
        return self._capture(copy, [np.array([s, s], np.int32)], pools)

    def _copy_block(self, src: int, dst: int) -> None:
        """Device-side CoW: clone page ``src`` into ``dst`` across all layers
        before the diverging write, as one step (captured at first use)."""
        if self._copy_fn is None:
            self._copy_fn = self._first_use(self._copy_step)
        with trace.span(self.tracer, "cow"):
            self._run_step(self._copy_fn, (np.array([src, dst], np.int32),),
                           "decode")
        self.cow_copies += 1

    def _decode_issue(self, reqs: List[Request]) -> object:
        with trace.span(self.tracer, "decode.prep"):
            inputs = self._decode_inputs(reqs)
        key = inputs[2].shape           # the tables': (batch, blocks)
        if key not in self._decode_fn:
            self._decode_fn[key] = self._first_use(self._decode_step, *key)
        logits, _ = self._run_step(self._decode_fn[key], inputs, "decode")
        return logits

    def _decode_inputs(self, reqs: List[Request]) -> Tuple[np.ndarray, ...]:
        """Each request's next token slot (a copy-on-write first where its
        last block is shared) and the decode step's inputs: tokens,
        positions, block tables and context lengths, padded to the (batch,
        blocks) bucket."""
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
        return tokens, pos_arr, tables, ctx

    # ------------------------------------------------------------- engine API
    def dispatch(self, batch: Batch, now: float) -> InFlight:
        """Launch one unified batch: block allocation, prefill + pool scatter
        and the paged decode step; logits stay on the device until ``wait``.
        Block frees of requests finishing in this batch happen in ``wait``."""
        with trace.span(self.tracer, "dispatch"):
            return self._dispatch(batch)

    def _dispatch(self, batch: Batch) -> InFlight:
        prefill_reqs = [r for r in batch.prefill_requests
                        if batch.completes_prompt(r)]
        pending: List = []
        utok = 0
        prefill_issue = 0.0
        if prefill_reqs:
            self._compile_s = 0.0
            t0 = _time.perf_counter()
            pending, utok = self._prefill_issue_batch(prefill_reqs)
            prefill_issue = max(0.0,
                                _time.perf_counter() - t0 - self._compile_s)
        reqs = [r for r in batch.decode_requests if r.req_id in self._active]
        decode_logits, decode_issue = None, 0.0
        if reqs:
            self._compile_s = 0.0
            t1 = _time.perf_counter()
            decode_logits = self._decode_issue(reqs)
            decode_issue = max(0.0,
                               _time.perf_counter() - t1 - self._compile_s)
        produced = {r.req_id: len(r.output_tokens) + 1
                    for r in (*(r for grp, _ in pending for r in grp), *reqs)}
        return InFlight(batch=batch, prefill_pending=pending,
                        decode_pending=decode_logits, decode_reqs=reqs,
                        decode_rows=[], utok=utok,
                        prefill_issue_s=prefill_issue,
                        decode_issue_s=decode_issue, produced=produced,
                        timed=self._take_timed())

    def wait(self, inflight: InFlight) -> Tuple[float, BatchResult]:
        """Same phase-separated timing contract as the dense executor:
        sample each prefill group then the decode step, free the blocks of
        anything that finished."""
        with trace.span(self.tracer, "wait"):
            return self._wait(inflight)

    def _wait(self, inflight: InFlight) -> Tuple[float, BatchResult]:
        outputs: Dict[str, Tuple[int, bool]] = {}
        prefill_dur = inflight.prefill_issue_s
        if inflight.prefill_pending:
            t0 = _time.perf_counter()
            for grp, logits in inflight.prefill_pending:
                with trace.span(self.tracer, "sample", phase="prefill"):
                    out_tokens = self._sample(logits)
                self._finish(grp, out_tokens, inflight, outputs)
            prefill_dur += _time.perf_counter() - t0
            self.prefill_samples.append((inflight.utok, prefill_dur))
        decode_dur = inflight.decode_issue_s
        if inflight.decode_pending is not None:
            t1 = _time.perf_counter()
            with trace.span(self.tracer, "sample", phase="decode"):
                out = self._sample(inflight.decode_pending)
            self._finish(inflight.decode_reqs, out, inflight, outputs)
            decode_dur += _time.perf_counter() - t1
            self.decode_samples.append((len(inflight.decode_reqs), decode_dur))
        with trace.span(self.tracer, "stash"):
            self._materialize_host_stash()
        self._note_device_ms(inflight)
        return prefill_dur + decode_dur, BatchResult(outputs)

    def _finish(self, reqs: List[Request], tokens: np.ndarray,
                inflight: InFlight, outputs: Dict[str, Tuple[int, bool]]) -> None:
        """Each request's sampled token into ``outputs``; the blocks of
        those that finished are freed."""
        with trace.span(self.tracer, "finish"):
            for i, r in enumerate(reqs):
                tok = int(tokens[i])
                finished = self._is_finish_token(r, tok,
                                                 inflight.produced[r.req_id])
                outputs[r.req_id] = (tok, finished)
                if finished:
                    self.release_request(r.req_id)

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
