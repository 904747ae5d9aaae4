"""Iteration-level schedulers. ``SchedulerBase`` owns queue mechanics, KV-cap
accounting and latency-phase bookkeeping (Definition 2.2); ``RelServeScheduler``
adds the paper's DPU + ABA pipeline (Fig. 6 steps 2-3). Baselines live in
``repro_torch.core.policies``.

All schedulers produce (and executors consume) the unified ``repro_torch.core.batch.
Batch`` type — candidate construction (`build_prefill_candidate`,
`build_decode_candidate`, `build_mixed_candidate`) and scheduled output are the
same objects, so the Adaptive Batch Arranger can evaluate chunked-mixed
batches as first-class candidates.

Queues are maintained *incrementally* (per-relQuery waiting lists + a running
list) so one scheduling iteration costs O(#relQueries + batch size), not
O(total requests) — at paper scale (~5k requests, tens of thousands of
iterations) this is the difference between seconds and hours.

The engine contract:
  batch = scheduler.schedule(now)              # None -> idle
  ... engine executes batch ...
  scheduler.complete_batch(batch, results, start_ts, end_ts)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.arranger import AdaptiveBatchArranger, ArrangerDecision
from repro_torch.core.batch import Batch
from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.predictor import OutputLenPredictor
from repro_torch.core.priority import (
    BatchLimits, DPUConfig, DynamicPriorityUpdater, PrefixCacheView,
)
from repro_torch.core.relquery import RelQuery, Request, RequestState
from repro_torch.engine.kv_cache import SharedPrefixLedger
from repro_torch.engine.prefix_cache import block_hashes


@dataclass
class BatchResult:
    """Engine-reported outcome: req_id -> (new_token, finished)."""
    outputs: Dict[str, Tuple[int, bool]]
    uncached_tokens: Optional[int] = None   # engine-measured true utok


KV_ADMISSION_MODES = ("conservative", "optimistic", "predicted")

# KV bytes one token occupies (all layers, K+V). Default models OPT-13B
# fp16: 2 (K,V) * 40 layers * 5120 hidden * 2 bytes — matches the a100_opt13b
# latency model the cost-based reclaim weighs swap transfers against.
KV_BYTES_PER_TOKEN = 819_200


class SchedulerBase:
    def __init__(self, limits: Optional[BatchLimits] = None,
                 latency_model: Optional[BatchLatencyModel] = None,
                 prefix_cache: Optional[PrefixCacheView] = None,
                 kv_admission: str = "conservative",
                 prefix_sharing: bool = False,
                 kv_tiering: bool = False,
                 host_kv_cap: int = 0,
                 swap_bandwidth_gbps: float = 32.0,
                 kv_bytes_per_token: int = KV_BYTES_PER_TOKEN,
                 predictor: Optional[OutputLenPredictor] = None,
                 proactive_offload: bool = False,
                 idle_horizon_s: Optional[float] = None,
                 swap_prefetch: bool = False):
        from repro_torch.core.latency_model import a100_opt13b
        if kv_admission not in KV_ADMISSION_MODES:
            raise ValueError(f"kv_admission must be one of {KV_ADMISSION_MODES}"
                             f" (got {kv_admission!r})")
        if kv_tiering and kv_admission == "conservative":
            raise ValueError("kv_tiering requires a preempting admission mode "
                             "(optimistic or predicted) — conservative "
                             "admission never evicts, so the host tier would "
                             "be dead weight")
        if kv_tiering and host_kv_cap <= 0:
            raise ValueError(f"kv_tiering requires host_kv_cap > 0 "
                             f"(got {host_kv_cap})")
        if kv_tiering and swap_bandwidth_gbps <= 0:
            raise ValueError(f"swap_bandwidth_gbps must be > 0 "
                             f"(got {swap_bandwidth_gbps})")
        if proactive_offload and not kv_tiering:
            raise ValueError("proactive_offload requires kv_tiering — without "
                             "a host tier there is nowhere to park idle-tail "
                             "KV")
        if swap_prefetch and not kv_tiering:
            raise ValueError("swap_prefetch requires kv_tiering — there are "
                             "no swap-ins to prefetch without a host tier")
        if idle_horizon_s is not None and not proactive_offload:
            raise ValueError("idle_horizon_s only applies with "
                             "proactive_offload on")
        if idle_horizon_s is not None and idle_horizon_s <= 0:
            raise ValueError(f"idle_horizon_s must be > 0 "
                             f"(got {idle_horizon_s})")
        self.limits = limits or BatchLimits()
        self.lm = latency_model or a100_opt13b()
        self.prefix_cache = prefix_cache
        self.kv_admission = kv_admission
        # --- tiered KV memory (device -> host -> recompute) ---
        self.kv_tiering = bool(kv_tiering)
        self.host_kv_cap = int(host_kv_cap)          # host-tier cap, tokens
        self.swap_bandwidth_bytes = float(swap_bandwidth_gbps) * 1e9
        self.kv_bytes_per_token = int(kv_bytes_per_token)
        self._swapped: List[Request] = []            # FCFS swap-in order
        self.host_tokens_in_use = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_out_tokens = 0
        self.swapped_in_tokens = 0
        self.swap_bytes_moved = 0
        self.reclaim_swap_decisions = 0
        self.reclaim_recompute_decisions = 0
        # swap ops the engine must mirror onto the executor before the next
        # dispatch: ("out" | "in" | "prefetch" | "prefetch_cancel", req_id,
        # tokens), in decision order
        self._swap_ops: List[Tuple[str, str, int]] = []
        # --- proactive tiering (FastServe-style offload + ALISE prefetch) ---
        self.proactive_offload = bool(proactive_offload)
        if self.proactive_offload and idle_horizon_s is None:
            # the horizon must sit well above a typical request's remaining
            # decode time: a victim below it is mid-flight work the batch
            # would have scheduled, and offloading it thrashes the swap
            # channel (measured: 2x avg-latency regression at 1s horizons on
            # the kv_pressure trace). 8s only catches genuine stragglers.
            idle_horizon_s = 8.0
        self.idle_horizon_s = idle_horizon_s
        self.swap_prefetch = bool(swap_prefetch)
        self.proactive_offloads = 0
        self.swap_prefetches = 0
        self.prefetch_cancelled = 0
        # proactively-offloaded victims: held on the host tier while admission
        # work is waiting, so offload->swap-in ping-pong can't oscillate
        self._proactive_out: Set[str] = set()
        # req_id -> tokens whose host->device copy was issued ahead of the
        # swap-in commit (the executor holds the staged blocks)
        self._prefetch_inflight: Dict[str, int] = {}
        # per-tick swap-channel state: requests resumed this tick are never
        # proactive victims in the same tick, and the queue ledger is the
        # contention term `_swap_cost_s` adds on top of the raw transfer
        self._resumed_this_tick: Set[str] = set()
        self._swap_tick_now: Optional[float] = None
        self._tick_swap_queue_s = 0.0
        # per-request charged footprint: under predicted admission the charge
        # is prediction-dependent, so releases must use the exact value that
        # was charged, not a recomputed one
        self._footprint_of: Dict[str, int] = {}
        # output-length prediction (predicted admission + DPU feed). Attached
        # only when asked for — a None predictor keeps every pre-existing
        # scheduling path untouched.
        if predictor is None and kv_admission == "predicted":
            predictor = OutputLenPredictor()
        self.predictor = predictor
        self._tmpl_key: Dict[str, int] = {}          # rel_id -> template key
        # Prefix-sharing-aware scheduling: warm-then-follow candidate pricing
        # plus shared-block KV admission (each shared prefix block charged
        # once against limits.cap). Off by default — every sharing-off code
        # path is bit-identical to the pre-sharing scheduler.
        self.prefix_sharing = bool(prefix_sharing)
        if self.prefix_sharing:
            block_size = getattr(prefix_cache, "block_size", None)
            if block_size is None:
                raise ValueError("prefix_sharing=True requires a block-based "
                                 "prefix cache (PrefixCache) on the scheduler")
            self._shared_ledger: Optional[SharedPrefixLedger] = \
                SharedPrefixLedger(block_size)
        else:
            self._shared_ledger = None
        self._prompt_keys: Dict[str, Tuple[int, ...]] = {}  # req_id -> chain
        self._kv_charged: Set[str] = set()            # req_ids in the ledger
        self.shared_tokens_saved = 0  # cumulative shared-block cap discount
        # memoized warm-then-follow orders, invalidated by any waiting-list
        # mutation (bump of _queue_version) — decode-heavy stretches rebuild
        # candidates every tick without touching the queues, and one tick
        # builds both the prefill and the mixed candidate from the same order
        self._queue_version = 0
        self._order_cache: Dict[str, Tuple[int, List[Request]]] = {}
        self.relqueries: Dict[str, RelQuery] = {}
        self.tokens_in_use = 0
        # Worst-case KV commitment: the full prompt+output footprint of every
        # request that has started prefilling (chunked or complete) and not
        # finished. Conservative admission checks use this, not tokens_in_use —
        # running requests grow into their footprint as they decode, so
        # admitting against current usage overcommits the cap. Optimistic
        # admission checks ``kv_demand()`` (current footprint) instead and
        # relies on priority-aware preemption when decode growth hits the cap.
        self.committed_tokens = 0
        # KV held by in-flight chunked prefills (chunks landed, prompt not yet
        # complete) — tokens_in_use only counts completed prefills, so the
        # optimistic demand measure needs this ledger on top.
        self.partial_prefill_tokens = 0
        self.iteration = 0
        self.finished_relqueries: List[RelQuery] = []
        # preemption instrumentation + executor-release handoff
        self.preemptions = 0
        self.preempted_tokens = 0          # KV tokens reclaimed by preemption
        self.missing_decode_outputs = 0    # decode reqs absent from BatchResult
        self._preempt_release: List[str] = []
        # Speculative-window journal (pipelined engine loop): while a
        # checkpoint is open, every shared-ledger acquire/release is logged so
        # ``rollback`` can replay the exact inverse ops. None = no open window.
        self._spec_log: Optional[List[Tuple[str, Tuple[int, ...]]]] = None
        # incremental queues
        self._waiting_of: Dict[str, List[Request]] = {}
        self._running: List[Request] = []
        self._unfinished = 0

    # ------------------------------------------------------------- queue state
    def add_relquery(self, rq: RelQuery, now: float) -> None:
        if any(r.state is not RequestState.WAITING or r.output_tokens
               or r.prefilled_tokens for r in rq.requests):
            # A relQuery with progress is a failover/drain re-admission from
            # another replica, not a fresh arrival — its generated tokens must
            # survive (preemption-style restart), not be double-queued.
            self.readmit_relquery(rq, now)
            return
        self.relqueries[rq.rel_id] = rq
        self._waiting_of[rq.rel_id] = list(rq.requests)
        self._queue_version += 1
        self._unfinished += 1
        self.on_relquery_added(rq, now)

    def readmit_relquery(self, rq: RelQuery, now: float) -> None:
        """Re-admit a relQuery recovered from another replica (crash failover
        or graceful drain). Non-terminal requests re-enter the waiting queue;
        any that already generated output restarts preemption-style — the
        next prefill pass recomputes prompt + preserved generation, and the
        preserved tokens are never re-emitted downstream. The relQuery brings
        no resident KV with it: whatever it held belonged to the replica that
        lost it, so no ledger is charged here."""
        if rq.rel_id in self.relqueries:
            raise ValueError(f"relQuery {rq.rel_id!r} is already admitted on "
                             f"this replica")
        waiting: List[Request] = []
        for r in rq.requests:
            if r.is_terminal():
                continue
            r.prefilled = False
            r.prefilled_tokens = 0
            r.finish_time = None
            if r.output_tokens:
                r.preserved_output_tokens = len(r.output_tokens)
                r.state = RequestState.PREEMPTED
            else:
                r.preserved_output_tokens = 0
                r.state = RequestState.WAITING
            waiting.append(r)
        rq.note_phase_change()
        self.relqueries[rq.rel_id] = rq
        if waiting:
            self._waiting_of[rq.rel_id] = waiting
            self._queue_version += 1
        if rq.finish_time is None and rq.cancel_time is None:
            self._unfinished += 1
        elif rq.finish_time is not None and rq.cancel_time is None:
            self.finished_relqueries.append(rq)
        self.on_relquery_added(rq, now)

    def remove_relquery(self, rel_id: str) -> Optional[RelQuery]:
        """Detach a live relQuery for migration to another replica (graceful
        drain). Only legal while it holds no replica-local KV: every
        non-terminal request WAITING or PREEMPTED with no landed chunks —
        resident work must finish (or be preempted) on this replica first.
        Unlike cancellation the relQuery stays live; the caller re-admits it
        elsewhere (``readmit_relquery``). Returns the detached relQuery, or
        None when unknown."""
        rq = self.relqueries.get(rel_id)
        if rq is None:
            return None
        for r in rq.requests:
            if r.is_terminal():
                continue
            if r.state not in (RequestState.WAITING, RequestState.PREEMPTED) \
                    or r.prefilled_tokens:
                raise ValueError(
                    f"cannot migrate relQuery {rel_id!r}: request "
                    f"{r.req_id} is {r.state.value} with resident KV")
        del self.relqueries[rel_id]
        self._waiting_of.pop(rel_id, None)
        self._order_cache.pop(rel_id, None)
        self._queue_version += 1
        self._tmpl_key.pop(rel_id, None)
        for r in rq.requests:
            self._prompt_keys.pop(r.req_id, None)
        if rq.finish_time is None and rq.cancel_time is None:
            self._unfinished -= 1
        self.on_relquery_removed(rq)
        return rq

    def on_relquery_added(self, rq: RelQuery, now: float) -> None:
        pass

    def on_relquery_removed(self, rq: RelQuery) -> None:
        pass

    def audit_ledgers(self, *, repair: bool = False) -> Dict[str, int]:
        """One audited source of truth for every token ledger, derived from
        the queues themselves: ``tokens_in_use`` is the resident KV of the
        running requests, ``partial_prefill_tokens`` the landed chunks of
        waiting requests, ``host_tokens_in_use`` the swapped population,
        ``committed_tokens`` the sum of charged footprints (the per-request
        charge is prediction-dependent, so the footprint map is the ledger of
        record, not a recomputation), and ``_unfinished`` the non-terminal
        relQuery count. ``repair=True`` assigns the derived values (the
        restore path); ``repair=False`` asserts the incremental ledgers match
        them exactly (the ``--debug-invariants`` per-tick audit)."""
        waiting = [r for lst in self._waiting_of.values() for r in lst]
        expected = {
            "tokens_in_use": sum(r.total_tokens for r in self._running),
            "partial_prefill_tokens": sum(r.prefilled_tokens for r in waiting),
            "host_tokens_in_use": sum(r.total_tokens for r in self._swapped),
            "committed_tokens": sum(self._footprint_of.values()),
            "_unfinished": sum(
                1 for rq in self.relqueries.values()
                if rq.finish_time is None and rq.cancel_time is None),
        }
        swapped_ids = {r.req_id for r in self._swapped}
        if repair:
            for key, value in expected.items():
                setattr(self, key, value)
            # proactive/prefetch tags are only meaningful for requests still
            # on the host tier — restore paths intersect them down
            self._proactive_out &= swapped_ids
            self._prefetch_inflight = {
                rid: tok for rid, tok in self._prefetch_inflight.items()
                if rid in swapped_ids}
            return expected
        for key, value in expected.items():
            got = getattr(self, key)
            assert got == value, (
                f"ledger drift: {key}={got} but queues imply {value}")
        assert self._proactive_out <= swapped_ids, (
            f"proactive-offload tags for non-swapped requests: "
            f"{sorted(self._proactive_out - swapped_ids)}")
        assert set(self._prefetch_inflight) <= swapped_ids, (
            f"prefetch staged for non-swapped requests: "
            f"{sorted(set(self._prefetch_inflight) - swapped_ids)}")
        owners = {r.req_id for r in self._running}
        owners |= {r.req_id for r in waiting if r.prefilled_tokens}
        charged = set(self._footprint_of)
        assert charged == owners, (
            f"footprint ledger drift: charged-but-not-resident="
            f"{sorted(charged - owners)}, resident-but-uncharged="
            f"{sorted(owners - charged)}")
        return expected

    def active_relqueries(self) -> List[RelQuery]:
        return [rq for rq in self.relqueries.values()
                if not rq.is_finished() and not rq.cancelled]

    def waiting_requests(self) -> List[Request]:
        out = []
        for rel_id in self._waiting_of:
            out.extend(self._waiting_of[rel_id])
        return out

    def running_requests(self) -> List[Request]:
        return list(self._running)

    def running_rqs(self) -> List[RelQuery]:
        seen, out = set(), []
        for r in self._running:
            if r.rel_id not in seen:
                seen.add(r.rel_id)
                out.append(self.relqueries[r.rel_id])
        return out

    def waiting_rqs(self) -> List[RelQuery]:
        running = {r.rel_id for r in self._running}
        return [self.relqueries[rel_id] for rel_id, lst in self._waiting_of.items()
                if lst and rel_id not in running]

    def has_work(self) -> bool:
        return self._unfinished > 0

    def swapped_requests(self) -> List[Request]:
        return list(self._swapped)

    def swapped_rqs(self) -> List[RelQuery]:
        seen, out = set(), []
        for r in self._swapped:
            if r.rel_id not in seen:
                seen.add(r.rel_id)
                out.append(self.relqueries[r.rel_id])
        return out

    def queue_depth(self) -> int:
        """Outstanding requests (waiting + running + swapped) without copying
        the queues — the router polls this on every arrival."""
        return (sum(len(lst) for lst in self._waiting_of.values())
                + len(self._running) + len(self._swapped))

    def stuck_rel_ids(self) -> List[str]:
        """relQueries with queued work (used in deadlock diagnostics)."""
        ids = {rel_id for rel_id, lst in self._waiting_of.items() if lst}
        ids.update(r.rel_id for r in self._running)
        ids.update(r.rel_id for r in self._swapped)
        return sorted(ids)

    # ------------------------------------------------------------- candidates
    def rq_sort_key(self, rq: RelQuery):
        """Waiting-queue order: ascending priority, FCFS tie-break."""
        return (rq.priority, rq.arrival_time, rq.rel_id)

    def sorted_waiting_rqs(self) -> List[RelQuery]:
        rqs = [self.relqueries[rel_id] for rel_id, lst in self._waiting_of.items() if lst]
        rqs.sort(key=self.rq_sort_key)
        return rqs

    def build_decode_candidate(self) -> Optional[Batch]:
        if not self._running:
            return None
        return Batch.decode(self._running[: self.limits.max_num_seqs])

    def estimated_utok(self, r: Request) -> int:
        """Estimated uncached tokens of the whole remaining prompt — the
        chunk estimate with the chunk covering everything left."""
        remaining = r.prefill_target_tokens - r.prefilled_tokens
        return max(1, self.estimated_chunk_utok(r, remaining))

    def estimated_chunk_utok(self, r: Request, chunk: int) -> int:
        """Estimated uncached tokens of the next ``chunk`` prompt tokens,
        mirroring the executor's chunked-prefill cache accounting with the
        sampled miss ratio in place of an exact prefix-cache probe. A
        preempted request's preserved generation is part of the target and
        never prefix-cached."""
        rq = self.relqueries[r.rel_id]
        n = r.num_prompt_tokens
        est_cached = n - max(1, round(n * rq.cache_miss_ratio))
        done = r.prefilled_tokens
        return max(0, min(done + chunk, r.prefill_target_tokens)
                   - max(done, est_cached))

    def _kv_footprint(self, r: Request) -> int:
        """KV a request is charged against the cap for. Conservative and
        optimistic admission charge the worst case (prompt+OL — the bound
        also covers preempted restarts: preserved tokens count toward OL).
        Predicted admission charges ``prompt + predicted_OL`` instead,
        clamped to at least what the request already holds plus one token
        (a request can't be charged below its resident KV) and never above
        the worst case. With no history the predictor abstains and the
        worst case applies."""
        worst = r.num_prompt_tokens + r.max_output_tokens
        if self.kv_admission != "predicted" or self.predictor is None:
            return worst
        pred = self.predictor.predict(self._template_key(r))
        if pred is None:
            return worst
        expected = r.num_prompt_tokens + max(pred, len(r.output_tokens) + 1)
        return min(worst, max(expected, r.total_tokens + 1))

    def _template_key(self, r: Request) -> int:
        key = self._tmpl_key.get(r.rel_id)
        if key is None:
            key = self.predictor.key_of(self.relqueries[r.rel_id])
            self._tmpl_key[r.rel_id] = key
        return key

    # ------------------------------------------------------------- prefix sharing
    def prompt_block_keys(self, r: Request) -> Tuple[int, ...]:
        """Chained block keys of ``r``'s prompt (cached — prompts are
        immutable). Only meaningful with prefix sharing enabled."""
        keys = self._prompt_keys.get(r.req_id)
        if keys is None:
            keys = tuple(block_hashes(r.tokens, self._shared_ledger.block_size))
            self._prompt_keys[r.req_id] = keys
        return keys

    def _sharing_order(self, rel_id: str,
                       reqs: Sequence[Request]) -> List[Request]:
        """Warm-then-follow order: lexicographic in the block-key chain, so
        requests sharing a prefix run adjacently — the first of each run is
        the leader that warms the cache for its followers. Preempted restarts
        keep their head-of-queue position; the sort is stable, so identical
        chains stay FCFS. Memoized until the next waiting-list mutation to
        preserve the module's O(#relQueries + batch size) iteration cost."""
        cached = self._order_cache.get(rel_id)
        if cached is not None and cached[0] == self._queue_version:
            return cached[1]
        ordered = sorted(reqs, key=lambda r: (
            r.state is not RequestState.PREEMPTED,
            self.prompt_block_keys(r)))
        self._order_cache[rel_id] = (self._queue_version, ordered)
        return ordered

    def _sharing_utok(self, r: Request, warm_keys: Set[int],
                      chunk: Optional[int] = None) -> Tuple[int, int]:
        """Exact-probe estimate for ``r``'s next ``chunk`` prompt tokens
        (default: all remaining), assuming ``warm_keys`` are resident by the
        time ``r`` executes — the post-leader hit rate of a follower in a
        warm-then-follow candidate. One chain walk returns both ``(uncached
        tokens, tokens saved vs a cache-only probe)`` — the saving is the
        intra-candidate reuse instrumentation, and walking twice for it
        would double the hot path's probe cost. Preserved generation
        (preempted restarts) is never prefix-cached."""
        cached = cold_cached = 0
        cold_alive = True       # the cache-only walk stops at the first
        block_size = self._shared_ledger.block_size   # warm-only block
        for k in self.prompt_block_keys(r):
            resident = self.prefix_cache.has_block(k)
            if resident or k in warm_keys:
                cached += block_size
                if resident and cold_alive:
                    cold_cached += block_size
                else:
                    cold_alive = False
            else:
                break
        done = r.prefilled_tokens
        target = r.prefill_target_tokens
        if chunk is None:
            chunk = target - done
        end = min(done + chunk, target)
        u = max(0, end - max(done, cached))
        u_cold = max(0, end - max(done, cold_cached))
        return u, u_cold - u

    def _shared_resident_tokens(self, r: Request,
                                pending_keys: Optional[Set[int]] = None) -> int:
        """Leading prompt tokens of ``r`` already charged against the cap by a
        live sibling (ledger) or by an earlier request of the candidate under
        construction (``pending_keys``) — admission may discount them."""
        if self._shared_ledger is None:
            return 0
        n = 0
        for k in self.prompt_block_keys(r):
            if self._shared_ledger.contains(k) or \
                    (pending_keys is not None and k in pending_keys):
                n += self._shared_ledger.block_size
            else:
                break
        return n

    def _kv_acquire(self, r: Request) -> None:
        """Register ``r``'s prompt chain in the shared-block ledger and pin
        the blocks against prefix-cache eviction. Timing is mode-dependent:
        conservative charges full footprints at the first chunk, so the chain
        is acquired there; optimistic charges only resident KV, so the chain
        is acquired at prompt *completion* — discounting a full chain while
        only partial chunks are resident would understate (even negate)
        ``kv_demand()`` and over-admit past the cap."""
        if self._shared_ledger is None or r.req_id in self._kv_charged:
            return
        keys = self.prompt_block_keys(r)
        self._kv_charged.add(r.req_id)
        self.shared_tokens_saved += self._shared_ledger.acquire(keys)
        self.prefix_cache.acquire_blocks(keys)
        if self._spec_log is not None:
            self._spec_log.append(("acquire", keys))

    def _kv_release(self, r: Request) -> None:
        """Drop ``r``'s charge from the shared-block ledger (finish, preempt
        or cancel). Blocks still referenced by siblings stay charged through
        the survivors — a victim never frees a sibling's shared prefix."""
        if self._shared_ledger is None or r.req_id not in self._kv_charged:
            return
        self._kv_charged.discard(r.req_id)
        keys = self.prompt_block_keys(r)
        self._shared_ledger.release(keys)
        self.prefix_cache.release_blocks(keys)
        if self._spec_log is not None:
            self._spec_log.append(("release", keys))

    # ------------------------------------------------------------- KV admission
    def kv_demand(self) -> int:
        """Tokens the admission check must assume resident. Conservative:
        worst-case commitment of every started request. Optimistic: the KV
        actually held right now (completed prefills + generation so far +
        landed chunks). Predicted: the larger of the predicted commitment and
        the resident KV — a request that outgrows its predicted footprint
        keeps counting in full, so under-predictions throttle admission
        instead of silently overcommitting (preemption is the safety valve
        past that). With prefix sharing the raw per-request charges are kept
        unchanged and the ledger's discount — tokens counted more than once
        because they live in shared blocks — is subtracted, so shared blocks
        count once against ``limits.cap`` in every mode. Swapped requests
        hold nothing on device and contribute to no term here — their KV is
        accounted in ``host_tokens_in_use``."""
        if self.kv_admission == "conservative":
            raw = self.committed_tokens
        elif self.kv_admission == "optimistic":
            raw = self.tokens_in_use + self.partial_prefill_tokens
        else:
            raw = max(self.committed_tokens,
                      self.tokens_in_use + self.partial_prefill_tokens)
        if self._shared_ledger is not None:
            return raw - self._shared_ledger.discount
        return raw

    def _resident_demand(self) -> int:
        """KV physically on the device right now (the optimistic measure,
        mode-independent) — what headroom preemption and swap-in gating must
        check against: committed-but-unwritten footprint can't overflow the
        device, resident KV can."""
        raw = self.tokens_in_use + self.partial_prefill_tokens
        if self._shared_ledger is not None:
            return raw - self._shared_ledger.discount
        return raw

    def _admission_need(self, r: Request,
                        pending_keys: Optional[Set[int]] = None) -> int:
        """Cap headroom required to schedule the rest of ``r``'s prefill.
        Conservative/predicted: the full (worst-case/predicted) footprint,
        charged once (already-started requests are pre-committed).
        Optimistic: only the KV this prefill pass will write, plus the decode
        token emitted on completion. Under prefix sharing both shrink by the
        prefix already charged by siblings — those blocks are resident once
        no matter how many requests share them. A request already charged
        (mid-chunk) gets no discount: its own chain is what the ledger holds,
        and its remaining chunks are raw."""
        shared = 0 if r.req_id in self._kv_charged else \
            self._shared_resident_tokens(r, pending_keys)
        if self.kv_admission != "optimistic":
            if r.prefilled_tokens:
                return 0
            return max(0, self._kv_footprint(r) - shared)
        uncharged = max(0, r.prefill_target_tokens
                        - max(r.prefilled_tokens, shared))
        return uncharged + 1

    def build_prefill_candidate(self, single_relquery: bool = True) -> Optional[Batch]:
        full_order = self.sorted_waiting_rqs()
        if not full_order:
            return None
        order = full_order[:1] if single_relquery else full_order
        sharing = self._shared_ledger is not None
        chosen: List[Request] = []
        utok_sum, full_tok_sum = 0, 0
        # warm-then-follow state: keys the candidate's leaders will have
        # inserted by the time a follower prefills, and the estimated tokens
        # that intra-candidate reuse saves (ABA instrumentation)
        warm_keys: Set[int] = set()
        pending_keys: Set[int] = set()
        shared_est = 0
        for rq in order:
            waiting = self._waiting_of[rq.rel_id]
            if sharing:
                waiting = self._sharing_order(rq.rel_id, waiting)
            for r in waiting:
                if sharing:
                    # exact probe, priced at the post-leader hit rate: the
                    # leader of each shared-prefix run pays its real misses,
                    # followers only their divergent suffix
                    u, saved = self._sharing_utok(r, warm_keys)
                    u = max(1, u)
                else:
                    u, saved = self.estimated_utok(r), 0
                if chosen and utok_sum + u > self.limits.max_num_batched_tokens:
                    break
                if len(chosen) + 1 > self.limits.max_num_seqs:
                    break
                needed = self._admission_need(r, pending_keys)
                if self.kv_demand() + full_tok_sum + needed > self.limits.cap:
                    break  # head-of-line: don't skip ahead of the cap-blocked rq
                chosen.append(r)
                utok_sum += u
                full_tok_sum += needed
                shared_est += saved
                if sharing:
                    keys = self.prompt_block_keys(r)
                    warm_keys.update(keys)
                    pending_keys.update(keys)
            else:
                continue
            break
        if chosen:
            rel = self.relqueries[chosen[0].rel_id] if single_relquery else None
            return Batch.prefill(chosen, uncached_tokens=utok_sum, relquery=rel,
                                 shared_prefix_tokens=shared_est)
        # Cap-blocked head of line. Fall back to requests whose KV is already
        # committed (partially chunked): under conservative admission finishing
        # them adds nothing to the commitment and is the only way the queue can
        # drain — without this, a committed request stranded behind a too-big
        # newcomer would turn into a spurious engine deadlock. Under optimistic
        # admission a mid-chunk request's *remaining* prefill is NOT yet
        # resident, so it still needs real cap headroom — requests that don't
        # fit are skipped (if none fit, the engine's preempt-and-retry reclaims
        # someone's partial chunks instead of overshooting the device cap).
        for rq in full_order:
            committed = [r for r in self._waiting_of[rq.rel_id] if r.prefilled_tokens]
            reqs, utok, need_sum = [], 0, 0
            for r in committed:   # same budget discipline as the main path
                u = self.estimated_utok(r)
                if reqs and (utok + u > self.limits.max_num_batched_tokens
                             or len(reqs) >= self.limits.max_num_seqs):
                    break
                if self.kv_admission == "optimistic":
                    need = self._admission_need(r)
                    if self.kv_demand() + need_sum + need > self.limits.cap:
                        continue   # its remaining chunks don't fit right now
                    need_sum += need
                reqs.append(r)
                utok += u
            if reqs:
                return Batch.prefill(reqs, uncached_tokens=utok,
                                     relquery=rq if single_relquery else None)
        return None

    def build_mixed_candidate(self, single_relquery: bool = False) -> Optional[Batch]:
        """Chunked-prefill candidate (Sarathi-style): all running requests
        decode one token while prompt chunks of the head waiting request(s)
        share the leftover token budget. Chunks consume raw prompt tokens
        from the budget (the pass computes over them either way); the
        candidate's ``uncached_tokens`` is the *estimated uncached* share, so
        ABA prices it on the same cache-discounted scale as pure prefill.
        Starting a chunk commits the request's whole prompt+output KV
        footprint against the cap (tracked in ``committed_tokens``)."""
        decode_reqs = self.running_requests()[: self.limits.max_num_seqs]
        budget = max(0, self.limits.max_num_batched_tokens - len(decode_reqs))
        sharing = self._shared_ledger is not None
        chunks: Dict[str, int] = {}
        prefill_reqs: List[Request] = []
        utok_sum, full_tok_sum, shared_est = 0, 0, 0
        warm_keys: Set[int] = set()
        pending_keys: Set[int] = set()
        order = self.sorted_waiting_rqs()
        if single_relquery:
            order = order[:1]
        for rq in order:
            if budget <= 0:
                break
            waiting = self._waiting_of[rq.rel_id]
            if sharing:
                waiting = self._sharing_order(rq.rel_id, waiting)
            for r in waiting:
                if budget <= 0 or \
                        len(decode_reqs) + len(prefill_reqs) >= self.limits.max_num_seqs:
                    break
                remaining = r.prefill_target_tokens - r.prefilled_tokens
                if self.kv_admission != "optimistic":
                    needed = self._admission_need(r, pending_keys)
                    if self.kv_demand() + full_tok_sum + needed > self.limits.cap:
                        budget = 0
                        break
                    chunk = min(remaining, budget)
                else:
                    # optimistic: the chunk itself is the commitment; shrink it
                    # to the cap headroom left after this pass's decode growth
                    free = self.limits.cap - self.kv_demand() \
                        - len(decode_reqs) - full_tok_sum
                    chunk = min(remaining, budget, max(0, free))
                    if chunk == remaining and chunk + 1 > free:
                        chunk -= 1   # completing the prompt emits a decode token
                    if chunk <= 0:
                        budget = 0
                        break
                    needed = chunk + (1 if chunk == remaining else 0)
                chunks[r.req_id] = chunk
                prefill_reqs.append(r)
                budget -= chunk
                if sharing:
                    u, saved = self._sharing_utok(r, warm_keys, chunk)
                    shared_est += saved
                    keys = self.prompt_block_keys(r)
                    completes = r.prefilled_tokens + chunk >= \
                        r.prefill_target_tokens
                    # the executor inserts a prompt into the prefix cache only
                    # when it *completes*: a partial chunk warms nothing yet
                    if completes:
                        warm_keys.update(keys)
                    # ledger membership mirrors _kv_acquire timing: first
                    # chunk (conservative/predicted) vs prompt completion
                    # (optimistic)
                    if completes or self.kv_admission != "optimistic":
                        pending_keys.update(keys)
                else:
                    u = self.estimated_chunk_utok(r, chunk)
                utok_sum += u
                full_tok_sum += needed
        if not decode_reqs and not prefill_reqs:
            return None
        return Batch.mixed(prefill_reqs, decode_reqs, chunks,
                           uncached_tokens=utok_sum,
                           shared_prefix_tokens=shared_est)

    # ------------------------------------------------------------- cancellation
    def cancel_relquery(self, rel_id: str, now: float) -> List[Request]:
        """Evict every waiting and running request of ``rel_id`` and reclaim
        its KV commitment. The relQuery becomes terminal (``cancel_time`` set)
        and is excluded from latency reporting; already-finished requests keep
        their outputs. Returns the evicted requests (for executor cleanup —
        they may hold decode slots). Idempotent: a finished or already
        cancelled relQuery returns []."""
        rq = self.relqueries.get(rel_id)
        if rq is None or rq.finish_time is not None or rq.cancel_time is not None:
            return []
        cancelled = list(self._waiting_of.pop(rel_id, []))
        self._queue_version += 1
        self._order_cache.pop(rel_id, None)
        mine = [r for r in self._running if r.rel_id == rel_id]
        if mine:
            self._running = [r for r in self._running if r.rel_id != rel_id]
            cancelled.extend(mine)
        mine_swapped = [r for r in self._swapped if r.rel_id == rel_id]
        if mine_swapped:
            self._swapped = [r for r in self._swapped if r.rel_id != rel_id]
            cancelled.extend(mine_swapped)
        for r in cancelled:
            # RUNNING requests hold prompt + generated tokens in the KV cache;
            # requests mid-chunk hold their landed chunks; SWAPPED requests
            # hold host-tier KV only (their committed charge was dropped at
            # swap-out, and the executor frees their host stash on release).
            # Any charged request releases the exact footprint it was charged
            # (mirrors complete_batch / _finish_request accounting). PREEMPTED
            # requests hold nothing — their KV was reclaimed at preemption.
            if r.state == RequestState.RUNNING:
                self.tokens_in_use -= r.total_tokens
            elif r.state == RequestState.SWAPPED:
                self.host_tokens_in_use -= r.total_tokens
            elif r.prefilled_tokens > 0:
                self.partial_prefill_tokens -= r.prefilled_tokens
            fp = self._footprint_of.pop(r.req_id, None)
            if fp is not None:
                self.committed_tokens -= fp
            self._kv_release(r)
            self._prompt_keys.pop(r.req_id, None)
            r.state = RequestState.CANCELLED
            r.finish_time = now
        pending_prefetch = {op[1] for op in self._swap_ops
                            if op[0] == "prefetch"}
        if self._swap_ops:
            # drop not-yet-drained swap ops for the cancelled requests: the
            # engine releases their executor state directly, so mirroring a
            # stale op would copy KV for a request that no longer exists
            gone = {r.req_id for r in cancelled}
            self._swap_ops = [op for op in self._swap_ops
                              if op[1] not in gone]
        # cancel-while-prefetching: a staged swap-in for a cancelled request
        # must release its device staging and refund this tick's bandwidth
        # ledger — the copy never happens, so the channel time it reserved is
        # given back. Prefetch ops still queued locally were purged above;
        # ops already drained to the executor need an explicit cancel op so
        # the staged device blocks are freed.
        for r in cancelled:
            self._proactive_out.discard(r.req_id)
            staged = self._prefetch_inflight.pop(r.req_id, None)
            if staged is None:
                continue
            self.prefetch_cancelled += 1
            self._tick_swap_queue_s = max(
                0.0, self._tick_swap_queue_s - self._xfer_s(staged))
            if r.req_id not in pending_prefetch:
                self._swap_ops.append(("prefetch_cancel", r.req_id, staged))
        rq.note_phase_change()
        rq.cancel_time = now
        self._unfinished -= 1
        self.on_relquery_cancelled(rq, now)
        return cancelled

    def on_relquery_cancelled(self, rq: RelQuery, now: float) -> None:
        pass

    # ------------------------------------------------------------- preemption
    def preempt_request(self, r: Request, now: float) -> None:
        """Reclaim ``r``'s KV under memory pressure. A RUNNING victim moves to
        ``PREEMPTED`` at the front of its relQuery's waiting list and restarts
        recompute-style (re-prefill of prompt + generation so far, generated
        tokens preserved); a mid-chunk victim just loses its landed chunks.
        The engine drains ``drain_preempt_releases`` to free executor slots."""
        rq = self.relqueries[r.rel_id]
        if r.state == RequestState.RUNNING:
            self.tokens_in_use -= r.total_tokens
            self.preempted_tokens += r.total_tokens
            self._running.remove(r)
            r.preserved_output_tokens = len(r.output_tokens)
            r.prefilled = False
            r.state = RequestState.PREEMPTED
            rq.note_phase_change()
            self._waiting_of.setdefault(r.rel_id, []).insert(0, r)
            self._queue_version += 1
        elif r.prefilled_tokens > 0:
            self.partial_prefill_tokens -= r.prefilled_tokens
            self.preempted_tokens += r.prefilled_tokens
        else:
            return                      # nothing on the device: no-op
        self.committed_tokens -= self._footprint_of.pop(
            r.req_id, self._kv_footprint(r))
        # the victim's ledger charge is dropped, but blocks its siblings still
        # reference stay discounted — preemption never frees shared KV twice
        self._kv_release(r)
        r.prefilled_tokens = 0
        self.preemptions += 1
        rq.preemptions += 1
        self._preempt_release.append(r.req_id)

    def drain_preempt_releases(self) -> List[str]:
        """req_ids preempted since the last drain — the engine frees their
        executor-side decode slots."""
        out, self._preempt_release = self._preempt_release, []
        return out

    # ------------------------------------------------------------- KV tiering
    def _xfer_s(self, tokens: int) -> float:
        """One-way transfer time of ``tokens`` of KV over the host link at
        the full budget — the unit the per-tick queue ledger accumulates."""
        return tokens * self.kv_bytes_per_token / self.swap_bandwidth_bytes

    def _swap_cost_s(self, tokens: int) -> float:
        """Modeled wall time to move ``tokens`` of KV device->host AND back
        (a swap is only worth taking if the round trip beats re-prefill).
        Swaps already decided this tick share the ``swap_bandwidth_gbps``
        budget, so the round trip queues behind them — under a swap storm
        the contention term pushes the break-even toward recompute. A tick's
        first swap sees an empty queue and prices exactly as the
        pre-contention model did."""
        return self._tick_swap_queue_s + 2.0 * self._xfer_s(tokens)

    def _should_swap(self, r: Request) -> bool:
        """Per-victim reclaim decision: swap beats recompute when moving the
        victim's KV over the host link (both ways) costs less than
        re-prefilling ``prompt + generation so far`` at the measured prefill
        rate — and the host tier has room. Mid-chunk victims always
        recompute: their partial chunks are not a resumable sequence."""
        if not self.kv_tiering or r.state != RequestState.RUNNING:
            return False
        tokens = r.total_tokens
        if self.host_tokens_in_use + tokens > self.host_kv_cap:
            return False
        recompute_s = self.lm.prefill_time(
            r.num_prompt_tokens + len(r.output_tokens))
        return self._swap_cost_s(tokens) < recompute_s

    def _reclaim(self, r: Request, now: float) -> None:
        """Reclaim a victim's device KV: swap to the host tier when the cost
        model favors it, recompute-preempt otherwise."""
        if self._should_swap(r):
            self.reclaim_swap_decisions += 1
            self.swap_out_request(r, now)
        else:
            if self.kv_tiering and r.state == RequestState.RUNNING:
                self.reclaim_recompute_decisions += 1
            self.preempt_request(r, now)

    def swap_out_request(self, r: Request, now: float) -> None:
        """Park a RUNNING victim's KV on the host tier. Unlike recompute
        preemption the request keeps its prefill progress and outputs: it
        resumes decoding (state SWAPPED -> RUNNING) once its blocks are
        swapped back — no re-prefill pass. The engine mirrors the move onto
        the executor via ``drain_swap_ops``."""
        rq = self.relqueries[r.rel_id]
        assert r.state == RequestState.RUNNING, r.state
        tokens = r.total_tokens
        self.tokens_in_use -= tokens
        self.committed_tokens -= self._footprint_of.pop(
            r.req_id, self._kv_footprint(r))
        self._running.remove(r)
        self._kv_release(r)
        r.state = RequestState.SWAPPED
        rq.note_phase_change()
        self._swapped.append(r)
        self.host_tokens_in_use += tokens
        self.swap_outs += 1
        self.swapped_out_tokens += tokens
        self.swap_bytes_moved += tokens * self.kv_bytes_per_token
        self._tick_swap_queue_s += self._xfer_s(tokens)
        self._swap_ops.append(("out", r.req_id, tokens))

    def _swap_in_request(self, r: Request, now: float) -> None:
        rq = self.relqueries[r.rel_id]
        assert r.state == RequestState.SWAPPED, r.state
        tokens = r.total_tokens
        self._swapped.remove(r)
        self.host_tokens_in_use -= tokens
        r.state = RequestState.RUNNING
        rq.note_phase_change()
        self._running.append(r)
        self.tokens_in_use += tokens
        fp = self._kv_footprint(r)
        self._footprint_of[r.req_id] = fp
        self.committed_tokens += fp
        self._kv_acquire(r)
        self.swap_ins += 1
        self.swapped_in_tokens += tokens
        self.swap_bytes_moved += tokens * self.kv_bytes_per_token
        self._proactive_out.discard(r.req_id)
        self._resumed_this_tick.add(r.req_id)
        if self._prefetch_inflight.pop(r.req_id, None) is None:
            # un-prefetched resume: the copy happens now and occupies the
            # shared channel this tick (a prefetched one already paid when
            # the copy was issued)
            self._tick_swap_queue_s += self._xfer_s(tokens)
        self._swap_ops.append(("in", r.req_id, tokens))

    def _swap_in_blocked(self, r: Request) -> bool:
        """A swapped request the resume scan must pass over: its relQuery is
        parked (the KV was offloaded *because* nobody will decode it), or it
        is a proactive victim and admission work is still waiting — resuming
        it would undo the offload and ping-pong against the next tick's
        pressure. Proactive victims resume once the waiting queue drains."""
        if self.relqueries[r.rel_id].parked:
            return True
        return (r.req_id in self._proactive_out
                and any(self._waiting_of.values()))

    def _pick_swap_in_candidate(self) -> Optional[Request]:
        """Next resume candidate: the first swapped request not blocked.
        With nothing blocked this is the FCFS head — identical to the
        pre-proactive scheduler."""
        for r in self._swapped:
            if not self._swap_in_blocked(r):
                return r
        return None

    def _maybe_swap_in(self, now: float) -> None:
        """Bring swapped requests back to device, FCFS (skipping blocked
        entries — parked relQueries and held proactive victims), while the
        *resident* measure plus one decode step fits under the cap. Progress
        guarantee: with nothing running and nothing waiting, the candidate
        swaps in as long as it alone fits the cap — a replica whose whole
        population is on the host tier must not idle forever. With prefetch
        enabled, the next candidate's host->device copy is issued now so a
        later commit finds the blocks already staged."""
        while self._swapped:
            r = self._pick_swap_in_candidate()
            if r is None:
                break
            tokens = r.total_tokens
            growth = min(len(self._running) + 1, self.limits.max_num_seqs)
            fits = (len(self._running) < self.limits.max_num_seqs
                    and self._resident_demand() + tokens + growth
                    <= self.limits.cap)
            force = (not self._running
                     and not any(self._waiting_of.values())
                     and self._resident_demand() + tokens <= self.limits.cap)
            if not (fits or force):
                break
            self._swap_in_request(r, now)
        if self.swap_prefetch:
            self._issue_swap_prefetch(now)

    def _issue_swap_prefetch(self, now: float) -> None:
        """Start the next resume candidate's host->device copy one tick
        early: the executor stages the blocks under this tick's compute, so
        when ``_maybe_swap_in`` commits the resume the copy has already been
        paid for. One candidate deep — prefetching further would speculate
        on a resume order that pressure may reshuffle. Timing-only: the
        resume decision itself is unchanged, so token streams are
        bit-identical prefetch-on vs off."""
        r = self._pick_swap_in_candidate()
        if r is None or r.req_id in self._prefetch_inflight:
            return
        tokens = r.total_tokens
        self._prefetch_inflight[r.req_id] = tokens
        self.swap_prefetches += 1
        self._tick_swap_queue_s += self._xfer_s(tokens)
        self._swap_ops.append(("prefetch", r.req_id, tokens))

    def _proactive_offload_tick(self, now: float) -> None:
        """FastServe-style proactive offload, run after resumes and *before*
        ``preempt_for_headroom``/``choose_batch`` — victims leave the running
        list before the batch is chosen, so a scheduled request is never
        evicted by construction. Three idle-tail victim classes:

        1. requests of parked relQueries (a derive stage blocked on upstream
           DAG results): their device KV is dead weight until unparked;
        2. overflow stragglers past the decode batch width: the decode
           candidate can never include them this tick;
        3. under pre-pressure (the head-of-line admission need does not fit
           the cap), the running request with the largest predicted remaining
           work, while that estimate exceeds the idle horizon.

        Victims are tagged in ``_proactive_out`` so ``_maybe_swap_in`` holds
        them on the host tier while admission work is waiting; requests
        resumed this tick are never re-offloaded in the same tick."""
        def can_offload(r: Request) -> bool:
            return (r.state == RequestState.RUNNING
                    and r.req_id not in self._resumed_this_tick
                    and self.host_tokens_in_use + r.total_tokens
                    <= self.host_kv_cap)

        def offload(r: Request) -> None:
            self.proactive_offloads += 1
            self._proactive_out.add(r.req_id)
            self.swap_out_request(r, now)

        for r in [r for r in self._running
                  if self.relqueries[r.rel_id].parked]:
            if can_offload(r):
                offload(r)
        width = min(self.limits.max_num_seqs,
                    self.limits.max_num_batched_tokens)
        for r in list(self._running[width:]):
            if can_offload(r):
                offload(r)
        if self.idle_horizon_s is None:
            return
        while True:
            need = self._progress_need()
            if need <= 0 or self.kv_demand() + need <= self.limits.cap:
                break       # no pre-pressure: nothing to make headroom for
            best: Optional[Request] = None
            best_s = self.idle_horizon_s
            for r in self._running:
                if not can_offload(r):
                    continue
                rem_s = self._predicted_remaining_s(r)
                if rem_s > best_s:
                    best, best_s = r, rem_s
            if best is None:
                break
            offload(best)

    def _predicted_remaining_s(self, r: Request) -> float:
        """Expected remaining decode wall time of ``r`` — the idle-horizon
        yardstick. Predictor-driven when history exists, worst-case
        ``remaining_output`` otherwise."""
        rem: Optional[int] = None
        if self.predictor is not None:
            rem = self.predictor.predicted_remaining(
                self._template_key(r), len(r.output_tokens))
        if rem is None:
            rem = r.remaining_output
        return rem * self.lm.decode_time(1)

    def drain_swap_ops(self) -> List[Tuple[str, str, int]]:
        """Swap decisions since the last drain, in order — the engine mirrors
        each onto the executor (device<->host copies) before dispatching the
        next batch."""
        out, self._swap_ops = self._swap_ops, []
        return out

    def _pick_preemption_victim(self) -> Optional[Request]:
        """Lowest-priority victim per the DPU: the running relQuery with the
        *highest* priority value (ascending priority == most urgent first, the
        same order ``rq_sort_key`` gives the waiting queue — FCFS baselines
        therefore preempt the latest arrival). Within the victim relQuery,
        the most recently started request yields first (least wasted work)."""
        rqs = self.running_rqs()
        if not rqs:
            return None
        victim_rq = max(rqs, key=self.rq_sort_key)
        for r in reversed(self._running):
            if r.rel_id == victim_rq.rel_id:
                return r
        return None

    def preempt_for_headroom(self, now: float) -> None:
        """Pressure valve for the preempting admission modes, run before
        every batch choice: while the next decode step over the running queue
        would exceed the cap, reclaim victims (swap or recompute, per the
        cost model) until it fits (or nothing is left running). The trigger
        is the *resident* measure — identical to ``kv_demand()`` under
        optimistic admission; under predicted admission the committed term is
        prediction headroom, not device bytes, so it must not trip the
        valve."""
        while self._running:
            growth = min(len(self._running), self.limits.max_num_seqs)
            if self._resident_demand() + growth <= self.limits.cap:
                break
            victim = self._pick_preemption_victim()
            if victim is None:
                break
            self._reclaim(victim, now)

    def preempt_for_progress(self, now: float) -> List[Request]:
        """Engine-deadlock escape hatch: when no batch is schedulable but work
        remains, reclaim low-priority KV and let the engine retry — running
        requests first, else mid-chunk requests' landed chunks (two half-loaded
        prompts can wedge against the cap with nothing running). Victims are
        picked in a *batch* per retry round: keep preempting until the
        head-of-line request's admission need fits under the cap, so one
        engine retry (one full re-sort of the waiting queue) suffices instead
        of one re-sort per victim. Returns the victims ([] when nothing can be
        preempted — conservative mode, or no KV left to reclaim: a genuine
        deadlock)."""
        if self.kv_admission == "conservative":
            return []
        victims: List[Request] = []
        while self.kv_demand() + self._progress_need() > self.limits.cap:
            victim = self._pick_preemption_victim() or self._pick_chunk_victim()
            if victim is None:
                break
            self._reclaim(victim, now)
            victims.append(victim)
        if not victims:
            # Cap pressure wasn't the (measurable) blocker — fall back to the
            # single-victim escape so the engine's retry loop still terminates
            # by strictly shrinking resident KV each round.
            victim = self._pick_preemption_victim() or self._pick_chunk_victim()
            if victim is None:
                return []
            self._reclaim(victim, now)
            victims.append(victim)
        return victims

    def _progress_need(self) -> int:
        """Cap headroom the head-of-line waiting request needs — the target
        ``preempt_for_progress`` batches victims toward. Mirrors
        ``build_prefill_candidate``'s order: highest-urgency relQuery, its
        first request in sharing (or FCFS) order."""
        order = self.sorted_waiting_rqs()
        if not order:
            return 0
        rq = order[0]
        waiting = self._waiting_of[rq.rel_id]
        if self._shared_ledger is not None:
            waiting = self._sharing_order(rq.rel_id, waiting)
        return self._admission_need(waiting[0])

    def _pick_chunk_victim(self) -> Optional[Request]:
        """A mid-chunk waiting request holding partial KV, from the
        lowest-priority relQuery that has one. Preempting it strictly shrinks
        resident partial KV, so the engine's retry loop terminates."""
        best_rq = None
        for rel_id, lst in self._waiting_of.items():
            if any(r.prefilled_tokens for r in lst):
                rq = self.relqueries[rel_id]
                if best_rq is None or self.rq_sort_key(rq) > self.rq_sort_key(best_rq):
                    best_rq = rq
        if best_rq is None:
            return None
        mine = [r for r in self._waiting_of[best_rq.rel_id] if r.prefilled_tokens]
        return mine[-1]   # least queue-progress first: deterministic, minimal waste

    # ------------------------------------------------------------- lifecycle
    def schedule(self, now: float) -> Optional[Batch]:
        """Template: refresh priorities, resume swapped requests that fit
        again (tiering), proactively offload idle tails, relieve KV pressure
        (preempting admission modes), then let the policy pick this
        iteration's batch."""
        self.refresh_priorities(now)
        if self.kv_tiering:
            if now != self._swap_tick_now:
                # fresh tick: the swap channel drained, resumes age out
                self._swap_tick_now = now
                self._tick_swap_queue_s = 0.0
                self._resumed_this_tick = set()
            self._maybe_swap_in(now)
            if self.proactive_offload:
                self._proactive_offload_tick(now)
        if self.kv_admission != "conservative":
            self.preempt_for_headroom(now)
        return self.choose_batch(now)

    def refresh_priorities(self, now: float) -> None:
        """Hook: recompute relQuery priorities before victim/batch choice."""

    def choose_batch(self, now: float) -> Optional[Batch]:
        raise NotImplementedError

    def complete_batch(self, batch: Batch, result: BatchResult,
                       start_ts: float, end_ts: float) -> None:
        self.iteration += 1
        touched_rels = set()
        for r in batch.prefill_requests:
            rq = self.relqueries[r.rel_id]
            if rq.first_prefill_start is None:
                rq.first_prefill_start = start_ts
            before = r.prefilled_tokens
            if before == 0:   # first chunk (or whole prompt) lands
                fp = self._kv_footprint(r)
                self._footprint_of[r.req_id] = fp
                self.committed_tokens += fp
                if self.kv_admission != "optimistic":
                    self._kv_acquire(r)   # leaders registered before followers
            target = r.prefill_target_tokens
            r.prefilled_tokens = min(target, before + batch.chunk_of(r))
            self.partial_prefill_tokens += r.prefilled_tokens - before
            if r.prefilled_tokens >= target and not r.prefilled:
                self.partial_prefill_tokens -= r.prefilled_tokens
                self._finish_prefill(r, rq, result, end_ts)
                touched_rels.add(r.rel_id)
        for r in batch.decode_requests:
            if r.req_id not in result.outputs:
                # The executor produced nothing for this request (e.g. its
                # slot vanished mid-batch). Fabricating a token here would
                # corrupt the output stream *and* the KV ledger — count it
                # and let the request be rescheduled instead.
                self.missing_decode_outputs += 1
                continue
            tok, finished = result.outputs[r.req_id]
            r.output_tokens.append(tok)
            self.tokens_in_use += 1
            if finished or r.remaining_output <= 0:
                self._finish_request(r, end_ts)
            touched_rels.add(r.rel_id)
        for rel_id in touched_rels:
            self._maybe_finish_relquery(self.relqueries[rel_id], end_ts)

    def _finish_prefill(self, r: Request, rq: RelQuery, result: BatchResult,
                        end_ts: float) -> None:
        r.prefilled = True
        r.state = RequestState.RUNNING
        rq.note_phase_change()
        wl = self._waiting_of.get(r.rel_id)
        if wl is not None and r in wl:
            wl.remove(r)
            self._queue_version += 1
            if not wl:
                del self._waiting_of[r.rel_id]
                self._order_cache.pop(r.rel_id, None)
        self._running.append(r)
        self.tokens_in_use += r.prefill_target_tokens
        self._kv_acquire(r)   # optimistic: chain resident only from here
        rq.last_prefill_end = end_ts   # monotone: last prefill wins
        out = result.outputs.get(r.req_id)
        if out is None:
            # Same guard as the decode path: no fabricated token 0 — the
            # prefill landed, so the request decodes next iteration instead.
            self.missing_decode_outputs += 1
            return
        tok, finished = out
        r.output_tokens.append(tok)
        self.tokens_in_use += 1
        if finished or r.remaining_output <= 0:
            self._finish_request(r, end_ts)

    def _finish_request(self, r: Request, end_ts: float) -> None:
        r.state = RequestState.FINISHED
        r.finish_time = end_ts
        self.relqueries[r.rel_id].note_phase_change()
        if r in self._running:
            self._running.remove(r)
        self.tokens_in_use -= r.total_tokens
        self.committed_tokens -= self._footprint_of.pop(
            r.req_id, self._kv_footprint(r))
        self._kv_release(r)
        self._prompt_keys.pop(r.req_id, None)
        if self.predictor is not None:
            self.predictor.observe(self._template_key(r), len(r.output_tokens))

    def _maybe_finish_relquery(self, rq: RelQuery, end_ts: float) -> None:
        if rq.finish_time is None and rq.is_finished():
            rq.finish_time = end_ts
            self.finished_relqueries.append(rq)
            self._unfinished -= 1

    # ------------------------------------------------- speculative checkpoint
    # Pipelined engine loop support: while batch N runs on device, the engine
    # projects N's completion onto the ledger and schedules batch N+1 against
    # the projection. ``checkpoint`` snapshots everything that one projected
    # ``complete_batch`` plus one speculative ``schedule`` (priority refresh,
    # headroom/progress preemptions, queue pops) can touch; ``rollback``
    # restores it bit-exactly when the device result contradicts the
    # projection (or the window must flush for an admit/cancel/snapshot).
    # Shared-ledger and prefix-pin refcounts are journaled in ``_spec_log``
    # and inverted op-by-op — no prefix-cache inserts or evictions happen
    # inside a window, so acquire/release are exact inverses.

    def checkpoint(self, batch: Batch) -> dict:
        reqs: Dict[str, Request] = {}
        for r in batch.prefill_requests:
            reqs[r.req_id] = r
        for r in batch.decode_requests:
            reqs[r.req_id] = r
        for r in self._running:
            reqs[r.req_id] = r
        for r in self._swapped:             # a speculative swap-in target
            reqs[r.req_id] = r
        for lst in self._waiting_of.values():
            for r in lst:
                if r.prefilled_tokens:      # mid-chunk: a chunk-victim target
                    reqs[r.req_id] = r
        cp = {
            "scalars": (self.tokens_in_use, self.committed_tokens,
                        self.partial_prefill_tokens, self.iteration,
                        self._unfinished, self.preemptions,
                        self.preempted_tokens, self.missing_decode_outputs,
                        self.shared_tokens_saved, self._queue_version),
            "tiering": (list(self._swapped), list(self._swap_ops),
                        self.host_tokens_in_use, self.swap_outs,
                        self.swap_ins, self.swapped_out_tokens,
                        self.swapped_in_tokens, self.swap_bytes_moved,
                        self.reclaim_swap_decisions,
                        self.reclaim_recompute_decisions,
                        set(self._proactive_out),
                        dict(self._prefetch_inflight),
                        set(self._resumed_this_tick),
                        self._swap_tick_now, self._tick_swap_queue_s,
                        self.proactive_offloads, self.swap_prefetches,
                        self.prefetch_cancelled),
            "footprints": dict(self._footprint_of),
            "waiting_of": {k: list(v) for k, v in self._waiting_of.items()},
            "running": list(self._running),
            "order_cache": dict(self._order_cache),
            "preempt_release": list(self._preempt_release),
            "n_finished_rqs": len(self.finished_relqueries),
            "kv_charged": set(self._kv_charged),
            "prompt_keys": dict(self._prompt_keys),
            "reqs": [(r, r.state, r.prefilled, r.prefilled_tokens,
                      len(r.output_tokens), r.finish_time,
                      r.preserved_output_tokens) for r in reqs.values()],
            "rqs": [(rq, rq.priority, rq.priority_fresh, rq._was_all_waiting,
                     rq.cache_miss_ratio, rq.preemptions,
                     rq.first_prefill_start, rq.last_prefill_end,
                     rq.finish_time)
                    for rq in self.relqueries.values()
                    if rq.finish_time is None and rq.cancel_time is None],
            "extra": self._checkpoint_extra(),
        }
        self._spec_log = []
        if self.predictor is not None:
            self.predictor.checkpoint()
        return cp

    def rollback(self, cp: dict) -> None:
        for op, keys in reversed(self._spec_log or []):
            if op == "acquire":
                self._shared_ledger.release(keys)
                self.prefix_cache.release_blocks(keys)
            else:
                self._shared_ledger.acquire(keys)
                self.prefix_cache.acquire_blocks(keys)
        self._spec_log = None
        if self.predictor is not None:
            self.predictor.rollback()
        (self.tokens_in_use, self.committed_tokens, self.partial_prefill_tokens,
         self.iteration, self._unfinished, self.preemptions,
         self.preempted_tokens, self.missing_decode_outputs,
         self.shared_tokens_saved, self._queue_version) = cp["scalars"]
        (self._swapped, self._swap_ops, self.host_tokens_in_use,
         self.swap_outs, self.swap_ins, self.swapped_out_tokens,
         self.swapped_in_tokens, self.swap_bytes_moved,
         self.reclaim_swap_decisions,
         self.reclaim_recompute_decisions,
         self._proactive_out, self._prefetch_inflight,
         self._resumed_this_tick,
         self._swap_tick_now, self._tick_swap_queue_s,
         self.proactive_offloads, self.swap_prefetches,
         self.prefetch_cancelled) = cp["tiering"]
        self._footprint_of = cp["footprints"]
        self._waiting_of = cp["waiting_of"]
        self._running = cp["running"]
        self._order_cache = cp["order_cache"]
        self._preempt_release = cp["preempt_release"]
        del self.finished_relqueries[cp["n_finished_rqs"]:]
        self._kv_charged = cp["kv_charged"]
        self._prompt_keys = cp["prompt_keys"]
        for (r, state, prefilled, ptoks, n_out, ft, preserved) in cp["reqs"]:
            r.state = state
            r.prefilled = prefilled
            r.prefilled_tokens = ptoks
            del r.output_tokens[n_out:]
            r.finish_time = ft
            r.preserved_output_tokens = preserved
        for (rq, prio, fresh, waswait, miss, pre, fps, lpe, ft) in cp["rqs"]:
            rq.priority = prio
            rq.priority_fresh = fresh
            rq._was_all_waiting = waswait
            rq.cache_miss_ratio = miss
            rq.preemptions = pre
            rq.first_prefill_start = fps
            rq.last_prefill_end = lpe
            rq.finish_time = ft
            rq.note_phase_change()     # invalidate any DPU phase memo
        self._restore_extra(cp["extra"])

    def discard_checkpoint(self) -> None:
        """Commit the speculative window: keep its mutations, close the
        journal."""
        self._spec_log = None
        if self.predictor is not None:
            self.predictor.discard()

    def _checkpoint_extra(self):
        """Policy hook: snapshot subclass state a speculative window touches."""
        return None

    def _restore_extra(self, extra) -> None:
        pass


class RelServeScheduler(SchedulerBase):
    """The paper's scheduler: DPU priority refresh + ABA batch choice over
    prefill, decode *and* chunked-mixed candidates."""

    name = "relserve"
    arrangement = "adaptive"   # 'adaptive' | 'prefill_first' | 'decode_first'
    enable_mixed = True        # offer a chunked-mixed candidate to ABA

    def __init__(self, limits=None, latency_model=None, prefix_cache=None,
                 dpu_config: Optional[DPUConfig] = None,
                 kv_admission: str = "conservative",
                 prefix_sharing: bool = False, **kw):
        super().__init__(limits, latency_model, prefix_cache, kv_admission,
                         prefix_sharing, **kw)
        self.dpu = DynamicPriorityUpdater(self.lm, self.limits, dpu_config)
        # ALISE-style feed: with a predictor attached, the DPU's
        # remaining-work estimate uses predicted output lengths instead of
        # the OL(R) worst case (None keeps the estimate bit-identical)
        self.dpu.predictor = self.predictor
        self.aba = AdaptiveBatchArranger(self.lm)
        # wall-clock overhead instrumentation (paper Table 6)
        self.dpu_time = 0.0
        self.aba_time = 0.0

    def on_relquery_cancelled(self, rq: RelQuery, now: float) -> None:
        # The DPU keeps a per-relQuery resample clock; drop it so the entry
        # can't alias a future relQuery reusing the id.
        self.dpu.forget(rq.rel_id)

    def on_relquery_removed(self, rq: RelQuery) -> None:
        # Migration (graceful drain) detaches the relQuery the same way
        # cancellation does as far as DPU identity is concerned: the
        # receiving replica's DPU starts it fresh.
        self.dpu.forget(rq.rel_id)

    def _checkpoint_extra(self):
        # A speculative schedule consumes DPU RNG draws and mutates the
        # resample clocks / instrumentation; restore all of it on rollback so
        # the post-flush *real* schedule sees the exact serial RNG stream.
        return (self.dpu._rng.getstate(), self.dpu._iteration,
                dict(self.dpu._last_sampled), dict(self.dpu.stats),
                dict(self.dpu._phase_memo), dict(self.aba.stats),
                self.dpu_time, self.aba_time)

    def _restore_extra(self, extra) -> None:
        (rng_state, it, sampled, dstats, memo, astats,
         self.dpu_time, self.aba_time) = extra
        self.dpu._rng.setstate(rng_state)
        self.dpu._iteration = it
        self.dpu._last_sampled = sampled
        self.dpu.stats = dstats
        self.dpu._phase_memo = memo
        self.aba.stats = astats

    def _dpu_targets(self) -> List[RelQuery]:
        """relQueries whose priority may need a refresh this iteration: every
        relQuery with waiting or running requests. Deterministic order (the
        DPU's sampling RNG is consumed in iteration order — a set here would
        make runs irreproducible across processes)."""
        out = self.running_rqs()
        seen = {rq.rel_id for rq in out}
        for rq in self.swapped_rqs():
            if rq.rel_id not in seen:
                seen.add(rq.rel_id)
                out.append(rq)
        for rel_id, lst in self._waiting_of.items():
            if lst and rel_id not in seen:
                seen.add(rel_id)
                out.append(self.relqueries[rel_id])
        return out

    def refresh_priorities(self, now: float) -> None:
        import time as _time
        t0 = _time.perf_counter()
        self.dpu.update(self._dpu_targets(), now, self.prefix_cache)
        self.dpu_time += _time.perf_counter() - t0

    def choose_batch(self, now: float) -> Optional[Batch]:
        import time as _time
        d_cand = self.build_decode_candidate()
        p_cand = self.build_prefill_candidate(single_relquery=True)
        m_cand = None
        if self.enable_mixed and d_cand is not None and p_cand is not None:
            m_cand = self.build_mixed_candidate(single_relquery=True)
            if m_cand is not None and not m_cand.prefill_requests:
                m_cand = None  # nothing to chunk: identical to the decode cand
        candidates = [c for c in (p_cand, d_cand, m_cand) if c is not None]
        if not candidates:
            return None

        t0 = _time.perf_counter()
        if self.arrangement == "adaptive":
            decision = self.aba.choose(candidates, self.running_rqs(),
                                       self.waiting_rqs(),
                                       lambda r: self.relqueries[r.rel_id].priority,
                                       now)
        elif self.arrangement == "prefill_first":
            decision = ArrangerDecision("prefill" if p_cand else "decode", "forced")
        else:  # decode_first
            decision = ArrangerDecision("decode" if d_cand else "prefill", "forced")
        self.aba_time += _time.perf_counter() - t0

        chosen = {c.kind: c for c in candidates}.get(decision.kind)
        if chosen is None:  # forced arrangement pointing at a missing candidate
            chosen = candidates[0]
        chosen.decision = decision
        return chosen
