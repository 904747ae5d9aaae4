"""Serving engine (Fig. 6), split into a steppable per-replica core.

``EngineCore`` owns one scheduler + one executor and exposes
``admit(rq, now)`` / ``tick(now) -> BatchEvent | None`` — the *caller* owns the
clock, which is what lets ``repro_torch.serving.Cluster`` drive N replicas on one
simulated timeline (and what a real async serving loop would do with
wall-clock time). ``ServingEngine`` is the single-replica convenience wrapper
that replays a whole arrival trace.

Works with either the simulated-clock executor (paper-scale traces) or the
real JAX executor (smoke-scale models). One tick = one scheduled batch.

Two engine loops share the tick interface (``engine_loop=`` selects one):

- ``serial`` — schedule, execute, complete: the device idles while Python
  picks the next batch.
- ``pipelined`` — the executor contract is split into ``dispatch``/``wait``;
  after dispatching batch N the engine *speculates*: it checkpoints the
  scheduler, applies N's predicted completion to the ledgers, schedules batch
  N+1 against the projection and pre-stages its prefill shape buckets, all
  while N runs on device. When ``wait`` lands, a matching prediction commits
  (placeholder tokens/timestamps patched with real values) and N+1 dispatches
  immediately next tick; a mismatch — or any admit/cancel/report between
  ticks — rolls the scheduler back and replays the real completion, so every
  externally observable state (token streams, simulated-clock reports, ledger
  invariants) is bit-identical to the serial loop.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batch import Batch
from repro_torch.core.relquery import RelQuery, Request
from repro_torch.core.scheduler import BatchResult, SchedulerBase

ENGINE_LOOPS = ("serial", "pipelined")

# Speculation placeholders: the projected completion of an in-flight batch
# appends _SPEC_TOKEN for every predicted output and stamps _SPEC_END as the
# batch end time; both are patched with real values at commit and can never
# leak (any read between ticks flushes the window first).
_SPEC_TOKEN = -1
_SPEC_END = float("-inf")


@dataclass
class BatchEvent:
    kind: str
    start: float
    end: float
    num_requests: int
    uncached_tokens: int
    rel_ids: Tuple[str, ...]
    replica: int = 0


class EngineDeadlockError(RuntimeError):
    """The scheduler still has work but can never make progress (e.g. a
    request that does not fit under the KV cap with nothing left running)."""

    def __init__(self, tokens_in_use: int, cap: int, stuck_rel_ids: Sequence[str],
                 replica: int = 0):
        self.tokens_in_use = tokens_in_use
        self.cap = cap
        self.stuck_rel_ids = list(stuck_rel_ids)
        self.replica = replica
        super().__init__(
            f"engine deadlock on replica {replica}: scheduler has work but no "
            f"batch is schedulable (tokens_in_use={tokens_in_use}, "
            f"cap={cap}, stuck relQueries={self.stuck_rel_ids})")


@dataclass
class ServiceReport:
    latencies: Dict[str, float]
    waiting: Dict[str, float]
    core: Dict[str, float]
    tail: Dict[str, float]
    events: List[BatchEvent]
    end_to_end: float
    dpu_time: float = 0.0
    aba_time: float = 0.0
    prefix_hit_ratio: float = 0.0
    prefix_lookup_tokens: int = 0   # hits + misses behind prefix_hit_ratio
    schedule_time: float = 0.0
    # scheduling-overhead split: first-try scheduling vs deadlock-retry
    # rounds, plus the wall-clock the pipelined loop hid behind device compute
    # (checkpoint + projection + speculative schedule + prestage)
    schedule_retry_time: float = 0.0
    overlap_hidden_time: float = 0.0
    schedule_retries: int = 0
    cancelled_rel_ids: List[str] = field(default_factory=list)
    # KV-pressure subsystem: preempt/restart cycles under optimistic admission
    preemptions: int = 0
    preempted_tokens: int = 0
    missing_decode_outputs: int = 0
    # prefix-sharing subsystem: cumulative cap tokens the shared-block
    # admission ledger discounted (0 with prefix sharing off)
    shared_kv_tokens: int = 0
    # planner subsystem: logical rows answered by dedup fan-out instead of
    # execution, and planner wall-clock (stamped by PlanExecutor.snapshot)
    deduped_requests: int = 0
    plan_time: float = 0.0
    # KV-tiering subsystem: device<->host swap traffic and the cost model's
    # per-victim reclaim decisions (all zero with tiering off)
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_out_tokens: int = 0
    swapped_in_tokens: int = 0
    swap_bytes_moved: int = 0
    reclaim_swap_decisions: int = 0
    reclaim_recompute_decisions: int = 0
    # proactive-tiering subsystem: idle-tail offloads ahead of pressure,
    # prefetched swap-ins (and how many committed with the copy fully
    # landed), and prefetches aborted by cancellation
    proactive_offloads: int = 0
    swap_prefetches: int = 0
    prefetch_hits: int = 0
    prefetch_cancelled: int = 0

    @property
    def avg_latency(self) -> float:
        return float(np.mean(list(self.latencies.values()))) if self.latencies else 0.0

    @property
    def max_latency(self) -> float:
        return float(np.max(list(self.latencies.values()))) if self.latencies else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(list(self.latencies.values()), p)) if self.latencies else 0.0

    def phase_means(self) -> Tuple[float, float, float]:
        def m(d):
            vals = [v for v in d.values() if v is not None]
            return float(np.mean(vals)) if vals else 0.0
        return m(self.waiting), m(self.core), m(self.tail)


def merge_reports(reports: Sequence[ServiceReport]) -> ServiceReport:
    """Fleet view: union the per-replica relQuery metrics, global end-to-end."""
    merged = ServiceReport(latencies={}, waiting={}, core={}, tail={},
                           events=[], end_to_end=0.0)
    hit_tokens = 0.0
    for rep in reports:
        merged.latencies.update(rep.latencies)
        merged.waiting.update(rep.waiting)
        merged.core.update(rep.core)
        merged.tail.update(rep.tail)
        merged.events.extend(rep.events)
        merged.end_to_end = max(merged.end_to_end, rep.end_to_end)
        merged.dpu_time += rep.dpu_time
        merged.aba_time += rep.aba_time
        merged.schedule_time += rep.schedule_time
        merged.schedule_retry_time += rep.schedule_retry_time
        merged.overlap_hidden_time += rep.overlap_hidden_time
        merged.schedule_retries += rep.schedule_retries
        # hit ratio is a per-token quantity: weight by lookup volume
        merged.prefix_lookup_tokens += rep.prefix_lookup_tokens
        hit_tokens += rep.prefix_hit_ratio * rep.prefix_lookup_tokens
        merged.cancelled_rel_ids.extend(rep.cancelled_rel_ids)
        merged.preemptions += rep.preemptions
        merged.preempted_tokens += rep.preempted_tokens
        merged.missing_decode_outputs += rep.missing_decode_outputs
        merged.shared_kv_tokens += rep.shared_kv_tokens
        merged.deduped_requests += rep.deduped_requests
        merged.plan_time += rep.plan_time
        merged.swap_outs += rep.swap_outs
        merged.swap_ins += rep.swap_ins
        merged.swapped_out_tokens += rep.swapped_out_tokens
        merged.swapped_in_tokens += rep.swapped_in_tokens
        merged.swap_bytes_moved += rep.swap_bytes_moved
        merged.reclaim_swap_decisions += rep.reclaim_swap_decisions
        merged.reclaim_recompute_decisions += rep.reclaim_recompute_decisions
        merged.proactive_offloads += rep.proactive_offloads
        merged.swap_prefetches += rep.swap_prefetches
        merged.prefetch_hits += rep.prefetch_hits
        merged.prefetch_cancelled += rep.prefetch_cancelled
    merged.events.sort(key=lambda e: (e.start, e.replica))
    merged.cancelled_rel_ids.sort()
    merged.prefix_hit_ratio = (hit_tokens / merged.prefix_lookup_tokens
                               if merged.prefix_lookup_tokens else 0.0)
    return merged


class EngineCore:
    """One serving replica: scheduler + executor behind a step interface."""

    def __init__(self, scheduler: SchedulerBase, executor, replica_id: int = 0,
                 record_events: bool = True, engine_loop: str = "serial",
                 debug_invariants: bool = False):
        if engine_loop not in ENGINE_LOOPS:
            raise ValueError(f"engine_loop must be one of {ENGINE_LOOPS} "
                             f"(got {engine_loop!r})")
        if engine_loop == "pipelined" and not hasattr(executor, "dispatch"):
            raise ValueError("engine_loop='pipelined' requires an executor "
                             "with the split dispatch/wait contract")
        self.scheduler = scheduler
        self.executor = executor
        self.replica_id = replica_id
        self.record_events = record_events
        self.engine_loop = engine_loop
        # per-tick ledger/block-pool consistency checks (off by default —
        # O(resident blocks) per tick; benchmarks turn it on under --smoke)
        self.debug_invariants = debug_invariants
        # finish-prediction rule for the speculative window: the simulated
        # executor terminates at the trace's sim_output_len; real executors
        # run to max_output_tokens unless a sampled EOS lands (unpredictable
        # — that path simply costs a rollback)
        self._predict_sim_len = bool(getattr(executor,
                                             "uses_sim_output_len", False))
        self.events: List[BatchEvent] = []
        self.schedule_time = 0.0
        self.schedule_retry_time = 0.0
        self.overlap_hidden_time = 0.0
        self.schedule_retries = 0
        self.iterations = 0
        # pipelined-loop speculative window (one batch deep): the pre-planned
        # next batch, the pre-projection checkpoint, the in-flight batch it
        # projected, and that batch's real (result, start, end) for flush
        self._plan: Optional[Batch] = None
        self._plan_cp: Optional[dict] = None
        self._plan_batch: Optional[Batch] = None
        self._plan_real: Optional[Tuple[BatchResult, float, float]] = None
        # Batch-completion listener (event, batch, result) — the open-loop
        # Frontend subscribes here to stream tokens and observe completions.
        self.on_batch: Optional[
            Callable[[BatchEvent, Batch, BatchResult], None]] = None

    # ------------------------------------------------------------------ steps
    def admit(self, rq: RelQuery, now: float) -> None:
        """Admit a relQuery. Executors exposing ``validate_relquery`` (the
        real backends) get to reject requests that can never fit their
        per-sequence KV capacity *before* the scheduler sees them — a
        too-long request used to overflow the dense slot buffer silently
        mid-decode instead of failing here with a clear error."""
        self._flush_plan()   # the pre-planned batch ignored this arrival
        validate = getattr(self.executor, "validate_relquery", None)
        if validate is not None:
            validate(rq)
        self.scheduler.add_relquery(rq, now)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def load(self) -> int:
        """Outstanding requests (waiting + running) — the router's load signal."""
        return self.scheduler.queue_depth()

    def tick(self, now: float) -> Optional[BatchEvent]:
        """Schedule + execute one batch at clock ``now``. Returns ``None`` when
        the replica is idle (nothing admitted and unfinished). Under optimistic
        KV admission a stalled scheduler is first asked to preempt
        lowest-priority running relQueries and retry; ``EngineDeadlockError``
        is reserved for work that can never be scheduled no matter what is
        evicted (a single request that does not fit under the cap)."""
        if self.engine_loop == "pipelined":
            return self._tick_pipelined(now)
        return self._tick_serial(now)

    def _tick_serial(self, now: float) -> Optional[BatchEvent]:
        batch = self._acquire_batch(now)
        if batch is None:
            return None
        swap_s = self._apply_swaps(now)
        duration, result = self.executor.execute(batch, now)
        start, end = now, now + duration + swap_s
        self.scheduler.complete_batch(batch, result, start, end)
        return self._finish_tick(batch, result, start, end)

    def _tick_pipelined(self, now: float) -> Optional[BatchEvent]:
        """Dispatch → speculate → wait → reconcile. The speculative window is
        exactly one batch deep: while the dispatched batch runs on device, its
        completion is projected onto the scheduler and the *next* batch is
        planned against the projection (the plan is consumed — or flushed — at
        the next tick). Every ledger mutation of the window sits behind a
        checkpoint, so reconcile on a misprediction is an exact rewind plus a
        replay with the device's real result."""
        if self._plan_cp is not None:
            # The previous window predicted correctly: its plan is the batch
            # to run, the window commits permanently, and executor slots of
            # any requests the speculative schedule preempted are freed now —
            # the same release-before-next-dispatch order as the serial loop.
            batch = self._take_plan()
            self._release_preempted()
            if batch is None:
                return None   # speculated idle (queue drained by that batch)
        else:
            batch = self._acquire_batch(now)
            if batch is None:
                return None
        # swaps the schedule decided on (speculative ones included — a
        # committed plan's journal survived, a flushed plan's was rolled
        # back) land on the device before the batch that relies on them
        swap_s = self._apply_swaps(now)
        inflight = self.executor.dispatch(batch, now)
        spec = self._speculate(batch, now)
        duration, result = self.executor.wait(inflight)
        start, end = now, now + duration + swap_s
        if spec is not None and self._prediction_matches(spec["predicted"],
                                                         result):
            self._commit_speculation(spec, batch, result, start, end)
        else:
            if spec is not None:
                self.scheduler.rollback(spec["cp"])
            self.scheduler.complete_batch(batch, result, start, end)
        return self._finish_tick(batch, result, start, end)

    def _acquire_batch(self, now: float) -> Optional[Batch]:
        """Schedule with the deadlock-escape retry loop (non-speculative)."""
        batch, deadlocked = self._retry_schedule(now)
        if deadlocked:
            # Nothing left to evict — admitting more work, advancing the
            # clock or reclaiming KV cannot help.
            raise EngineDeadlockError(self.scheduler.tokens_in_use,
                                      self.scheduler.limits.cap,
                                      self.scheduler.stuck_rel_ids(),
                                      self.replica_id)
        return batch

    def _retry_schedule(self, now: float) -> Tuple[Optional[Batch], bool]:
        """Schedule; while nothing is schedulable but work remains, preempt a
        *round* of victims and retry. Returns (batch, deadlocked)."""
        batch = self._schedule(now)
        while batch is None and self.scheduler.has_work():
            if not self.scheduler.preempt_for_progress(now):
                return None, True
            self.schedule_retries += 1
            batch = self._schedule(now, retry=True)
        return batch, False

    def _apply_swaps(self, now: float = 0.0) -> float:
        """Mirror the scheduler's swap decisions onto the executor *before*
        the next dispatch: a swap-out must free device KV before the batch
        that was admitted into that headroom runs, a swap-in must restore it
        before the request decodes, and a prefetch stages the copy early so
        the later swap-in commit finds it landed (prefetch_cancel undoes a
        staging whose request was cancelled first). Returns the seconds of
        swap transfer the executor charges to this tick (0.0 for real
        executors, which overlap the copies with dispatch/wait; the simulated
        executor prices a shared-bandwidth channel)."""
        ops = self.scheduler.drain_swap_ops()
        if not ops:
            return 0.0
        begin = getattr(self.executor, "begin_swap_tick", None)
        if begin is not None:
            begin(now)
        hooks = {
            "out": getattr(self.executor, "swap_out", None),
            "in": getattr(self.executor, "swap_in", None),
            "prefetch": getattr(self.executor, "prefetch_swap_in", None),
            "prefetch_cancel": getattr(self.executor,
                                       "cancel_swap_prefetch", None),
        }
        swap_s = 0.0
        for kind, req_id, tokens in ops:
            hook = hooks[kind]
            if hook is not None:
                swap_s += hook(req_id, tokens)
        return swap_s

    def _check_invariants(self) -> None:
        """Per-tick consistency sweep (``debug_invariants``): scheduler token
        ledgers stay non-negative and within cap-accounting bounds, the
        shared-prefix ledger's discount matches its refcounts, and any real
        block pool conserves device+host blocks exactly."""
        s = self.scheduler
        assert s.tokens_in_use >= 0, f"tokens_in_use={s.tokens_in_use}"
        assert s.committed_tokens >= 0, f"committed_tokens={s.committed_tokens}"
        assert s.partial_prefill_tokens >= 0
        if hasattr(s, "audit_ledgers"):
            # every incremental ledger must equal its queue-derived value —
            # the same derivation restore_scheduler rebuilds from
            s.audit_ledgers(repair=False)
        host = getattr(s, "host_tokens_in_use", 0)
        assert host >= 0, f"host_tokens_in_use={host}"
        cap = getattr(s, "host_kv_cap", 0)
        if getattr(s, "kv_tiering", False):
            assert host <= cap, f"host tier over cap: {host} > {cap}"
        ledger = getattr(s, "_shared_ledger", None)
        if ledger is not None:
            ledger.check_invariants()
        bm = getattr(self.executor, "bm", None)
        if bm is not None:
            bm.check_invariants()

    def _finish_tick(self, batch: Batch, result: BatchResult, start: float,
                     end: float) -> BatchEvent:
        if self.debug_invariants:
            self._check_invariants()
        self.iterations += 1
        event = BatchEvent(batch.kind, start, end, batch.num_requests,
                           batch.uncached_tokens, batch.rel_ids(),
                           self.replica_id)
        if self.record_events:
            self.events.append(event)
        if self.on_batch is not None:
            self.on_batch(event, batch, result)
        return event

    def _schedule(self, now: float, retry: bool = False) -> Optional[Batch]:
        """One timed scheduler call, then free executor slots of any requests
        the scheduler preempted while choosing (headroom or retry preemption
        both funnel through ``drain_preempt_releases``)."""
        t0 = _time.perf_counter()
        batch = self.scheduler.schedule(now)
        dt = _time.perf_counter() - t0
        if retry:
            self.schedule_retry_time += dt
        else:
            self.schedule_time += dt
        self._release_preempted()
        return batch

    # ------------------------------------------------------- speculative window
    def _can_speculate(self) -> bool:
        """Speculative scheduling runs at the in-flight batch's *start* time.
        No policy's batch choice reads the clock — except the DPU starvation
        promotion (Eq. 13), which compares waiting time against ``now`` — so
        speculation is decision-identical exactly when starvation prevention
        is off."""
        dpu = getattr(self.scheduler, "dpu", None)
        return dpu is None or dpu.cfg.starvation_threshold is None

    def _predict_result(self, batch: Batch) -> BatchResult:
        """Predicted completion of ``batch``: which requests emit a token and
        whether they finish. Token *values* are placeholders — nothing reads
        them before commit patches in the real ones. Finish prediction mirrors
        the simulated executor's length rule exactly (bit-identical simulated
        runs); real executors additionally finish on sampled EOS, which simply
        lands in the mismatch → rollback path."""
        outputs: Dict[str, Tuple[int, bool]] = {}
        for r in batch.prefill_requests:
            if batch.completes_prompt(r):
                outputs[r.req_id] = (_SPEC_TOKEN, self._predict_finished(r))
        for r in batch.decode_requests:
            outputs[r.req_id] = (_SPEC_TOKEN, self._predict_finished(r))
        return BatchResult(outputs)

    def _predict_finished(self, r: Request) -> bool:
        produced = len(r.output_tokens) + 1
        target = r.max_output_tokens
        if self._predict_sim_len:
            sim = getattr(r, "sim_output_len", None) or target
            target = min(sim, target)
        return produced >= target

    @staticmethod
    def _prediction_matches(predicted: BatchResult, real: BatchResult) -> bool:
        if predicted.outputs.keys() != real.outputs.keys():
            return False
        return all(predicted.outputs[k][1] == real.outputs[k][1]
                   for k in real.outputs)

    def _speculate(self, batch: Batch, now: float) -> Optional[dict]:
        """While ``batch`` runs on device: checkpoint, project its predicted
        completion onto the ledgers, schedule the next batch against the
        projection (with the same deadlock-retry loop, except a genuine
        deadlock rolls back and defers to the next real tick instead of
        raising), and pre-stage the plan's prefill shape buckets. Executor
        slot releases for speculatively preempted victims are deferred until
        the plan is actually dispatched — device state is not rewindable.
        Returns the window dict, or None when speculation is off/unsafe."""
        if not self._can_speculate():
            return None
        sched = self.scheduler
        t_start = _time.perf_counter()
        cp = sched.checkpoint(batch)
        predicted = self._predict_result(batch)
        sched.complete_batch(batch, predicted, now, _SPEC_END)
        patches = [(r, len(r.output_tokens) - 1)
                   for r in (*batch.prefill_requests, *batch.decode_requests)
                   if r.req_id in predicted.outputs]
        t0 = _time.perf_counter()
        plan = sched.schedule(now)
        sched_s = _time.perf_counter() - t0
        retry_s, retries = 0.0, 0
        while plan is None and sched.has_work():
            t0 = _time.perf_counter()
            if not sched.preempt_for_progress(now):
                sched.rollback(cp)
                return None   # genuine deadlock: surface it un-speculated
            retries += 1
            plan = sched.schedule(now)
            retry_s += _time.perf_counter() - t0
        prestage = getattr(self.executor, "prestage", None)
        if plan is not None and prestage is not None:
            prestage(plan)
        return {"cp": cp, "predicted": predicted, "patches": patches,
                "plan": plan, "sched_s": sched_s, "retry_s": retry_s,
                "retries": retries,
                "spec_s": _time.perf_counter() - t_start}

    def _commit_speculation(self, spec: dict, batch: Batch,
                            result: BatchResult, start: float,
                            end: float) -> None:
        """The device agreed with the projection: patch placeholder tokens and
        timestamps with the real values and adopt the planned next batch. The
        checkpoint (and its op journal) stays open until the plan is consumed
        or flushed — an admit/cancel/snapshot between ticks still needs the
        exact rewind."""
        for r, idx in spec["patches"]:
            r.output_tokens[idx] = result.outputs[r.req_id][0]
        rqs = {}
        for r in (*batch.prefill_requests, *batch.decode_requests):
            if r.finish_time == _SPEC_END:
                r.finish_time = end
            rqs[r.rel_id] = self.scheduler.relqueries[r.rel_id]
        for rq in rqs.values():
            if rq.last_prefill_end == _SPEC_END:
                rq.last_prefill_end = end
            if rq.finish_time == _SPEC_END:
                rq.finish_time = end
        self.schedule_time += spec["sched_s"]
        self.schedule_retry_time += spec["retry_s"]
        self.schedule_retries += spec["retries"]
        self.overlap_hidden_time += spec["spec_s"]
        self._plan = spec["plan"]
        self._plan_cp = spec["cp"]
        self._plan_batch = batch
        self._plan_real = (result, start, end)

    def _take_plan(self) -> Optional[Batch]:
        """Consume the pre-planned batch, committing the previous window for
        good (the journal closes; no rewind past this point)."""
        plan = self._plan
        self.scheduler.discard_checkpoint()
        self._drop_plan_state()
        return plan

    def _flush_plan(self) -> None:
        """Un-speculate: rewind to the pre-projection checkpoint and replay
        the in-flight batch's *real* completion, leaving exactly the state
        the serial loop would have between ticks. Called before any
        between-tick interaction the plan could not have seen — admit,
        cancel, report/snapshot."""
        if self._plan_cp is None:
            return
        result, start, end = self._plan_real
        batch = self._plan_batch
        self.scheduler.rollback(self._plan_cp)
        self._drop_plan_state()
        self.scheduler.complete_batch(batch, result, start, end)

    def _drop_plan_state(self) -> None:
        self._plan = None
        self._plan_cp = None
        self._plan_batch = None
        self._plan_real = None

    def _release_preempted(self) -> None:
        release = getattr(self.executor, "release_request", None)
        for req_id in self.scheduler.drain_preempt_releases():
            if release is not None:
                release(req_id)

    def cancel_relquery(self, rel_id: str, now: float) -> List[Request]:
        """Cancel a relQuery between ticks: evict its queued/running requests
        from the scheduler (reclaiming ``tokens_in_use``/``committed_tokens``)
        and release any executor-side state (decode slots) they hold. Returns
        the evicted requests; [] if the relQuery is unknown or terminal."""
        self._flush_plan()   # the pre-planned batch may contain the victim
        cancelled = self.scheduler.cancel_relquery(rel_id, now)
        release = getattr(self.executor, "release_request", None)
        if release is not None:
            for r in cancelled:
                release(r.req_id)
        return cancelled

    # ------------------------------------------------------------------ report
    def report(self, end_time: float) -> ServiceReport:
        """Service metrics as of ``end_time``. Safe to call mid-flight (the
        Frontend's ``snapshot()``): unfinished relQueries simply have no
        latency entry yet. Cancelled relQueries are excluded from every
        latency statistic and listed in ``cancelled_rel_ids``."""
        self._flush_plan()   # mid-flight views must not see speculative state
        all_rqs = list(self.scheduler.relqueries.values())
        cancelled = [rq.rel_id for rq in all_rqs if rq.cancelled]
        rqs = [rq for rq in all_rqs if not rq.cancelled]
        lat = {rq.rel_id: rq.latency() for rq in rqs if rq.latency() is not None}
        waiting = {rq.rel_id: rq.waiting_time() for rq in rqs}
        core = {rq.rel_id: rq.core_running_time() for rq in rqs}
        tail = {rq.rel_id: rq.tail_running_time() for rq in rqs}
        pc = getattr(self.scheduler, "prefix_cache", None)
        return ServiceReport(
            latencies=lat, waiting=waiting, core=core, tail=tail,
            events=self.events, end_to_end=end_time,
            dpu_time=getattr(self.scheduler, "dpu_time", 0.0),
            aba_time=getattr(self.scheduler, "aba_time", 0.0),
            prefix_hit_ratio=pc.hit_ratio if pc is not None else 0.0,
            prefix_lookup_tokens=(getattr(pc, "hits", 0) + getattr(pc, "misses", 0)
                                  if pc is not None else 0),
            schedule_time=self.schedule_time,
            schedule_retry_time=self.schedule_retry_time,
            overlap_hidden_time=self.overlap_hidden_time,
            schedule_retries=self.schedule_retries,
            cancelled_rel_ids=cancelled,
            preemptions=getattr(self.scheduler, "preemptions", 0),
            preempted_tokens=getattr(self.scheduler, "preempted_tokens", 0),
            missing_decode_outputs=getattr(self.scheduler,
                                           "missing_decode_outputs", 0),
            shared_kv_tokens=getattr(self.scheduler, "shared_tokens_saved", 0),
            swap_outs=getattr(self.scheduler, "swap_outs", 0),
            swap_ins=getattr(self.scheduler, "swap_ins", 0),
            swapped_out_tokens=getattr(self.scheduler, "swapped_out_tokens", 0),
            swapped_in_tokens=getattr(self.scheduler, "swapped_in_tokens", 0),
            swap_bytes_moved=getattr(self.scheduler, "swap_bytes_moved", 0),
            reclaim_swap_decisions=getattr(self.scheduler,
                                           "reclaim_swap_decisions", 0),
            reclaim_recompute_decisions=getattr(self.scheduler,
                                                "reclaim_recompute_decisions",
                                                0),
            proactive_offloads=getattr(self.scheduler,
                                       "proactive_offloads", 0),
            swap_prefetches=getattr(self.scheduler, "swap_prefetches", 0),
            prefetch_hits=getattr(self.executor, "prefetch_hits", 0),
            prefetch_cancelled=getattr(self.scheduler,
                                       "prefetch_cancelled", 0),
        )


class ServingEngine:
    """Single-replica trace driver built on ``EngineCore``."""

    def __init__(self, scheduler: SchedulerBase, executor,
                 engine_loop: str = "serial", debug_invariants: bool = False):
        self.core = EngineCore(scheduler, executor, engine_loop=engine_loop,
                               debug_invariants=debug_invariants)

    @property
    def scheduler(self) -> SchedulerBase:
        return self.core.scheduler

    @property
    def executor(self):
        return self.core.executor

    @property
    def events(self) -> List[BatchEvent]:
        return self.core.events

    @property
    def schedule_time(self) -> float:
        return self.core.schedule_time

    def run_trace(self, trace: Sequence[RelQuery], max_iterations: int = 2_000_000,
                  record_events: bool = True) -> ServiceReport:
        """Replay a full arrival trace on the simulated clock.

        .. deprecated:: closed-loop compatibility shim. The open-loop
           ``repro_torch.serving.Frontend`` (submit / stream / cancel / snapshot) is
           the serving API; this method is now a thin trace-replay driver over
           it and produces the identical ``ServiceReport``.
        """
        from repro_torch.serving.frontend import Frontend

        self.core.record_events = record_events
        fe = Frontend(self.core)
        try:
            fe.replay(trace, max_iterations=max_iterations)
        finally:
            fe.close()
        return self.core.report(fe.clock)
