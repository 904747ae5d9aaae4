"""Dynamic Priority Updater (paper §4.2).

PEM simulates the remaining execution of a relQuery: Batch Decomposition
(Algorithm 1) splits R_t into prefill/decode batches under the engine limits,
then the linear predictors price each batch (Eq. 10). Fast estimation:
``utok*`` replaces exact prefix-cache matching with a sampled miss ratio
(Eq. 11); priorities are reused across iterations while a relQuery sits wholly
in the waiting queue (Eq. 12). Starvation prevention forces priority 0 once
``unit_waiting_time`` exceeds a threshold (Eq. 13).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.relquery import RelQuery, Request, RequestState


class PrefixCacheView(Protocol):
    """What the DPU needs from the engine's prefix cache."""

    def count_cached(self, tokens: Sequence[int]) -> int: ...


@dataclass(frozen=True)
class BatchLimits:
    max_num_batched_tokens: int = 2048   # mnbt: prefill batch token cap
    max_num_seqs: int = 256              # mns: decode batch request cap
    cap: int = 16384                     # KV-resident token cap on the device


@dataclass
class SimBatch:
    """A batch in PEM's simulated decomposition."""
    kind: str                 # 'prefill' | 'decode'
    utok: int = 0             # uncached tokens (prefill)
    reqs: int = 0             # request count (decode)


def batch_decompose(utoks: Sequence[int], output_len: int, already_running: int,
                    limits: BatchLimits) -> List[SimBatch]:
    """Algorithm 1. ``utoks``: uncached token counts of *not-yet-prefilled*
    requests of R_t; ``already_running``: R_t requests already prefilled (they
    join decode batches with utok = 0)."""
    P: List[SimBatch] = []
    D: List[SimBatch] = []
    p_tok, p_reqs = 0, 0
    d_reqs = already_running
    accum = 0
    n = len(utoks)
    for i, u in enumerate(utoks):
        if u + accum > limits.cap or d_reqs + 1 > limits.max_num_seqs:
            # device full: flush pending prefill, decode everyone to completion
            if p_reqs:
                P.append(SimBatch("prefill", utok=p_tok))
            for _ in range(output_len):
                D.append(SimBatch("decode", reqs=d_reqs))
            p_tok, p_reqs, d_reqs, accum = 0, 0, 0, 0
        if u + p_tok > limits.max_num_batched_tokens and p_reqs:
            P.append(SimBatch("prefill", utok=p_tok))
            p_tok, p_reqs = 0, 0
        p_tok += u
        p_reqs += 1
        d_reqs += 1
        accum += u
    if p_reqs or d_reqs:
        if p_reqs:
            P.append(SimBatch("prefill", utok=p_tok))
        for _ in range(output_len):
            D.append(SimBatch("decode", reqs=d_reqs))
    return P + D


@dataclass
class DPUConfig:
    sample_size: int = 8                 # |R_t^s| for Eq. 11
    starvation_threshold: Optional[float] = None  # seconds per request (Eq. 13)
    resample_every: int = 16             # refresh miss ratio every N iterations
    seed: int = 0
    # Exact-probe mode: replace Eq. 11's sampled miss ratio with a full probe
    # of every pending request, *including* the intra-relQuery sharing that
    # warm-then-follow scheduling will realize (a leader's prompt warms the
    # cache for its followers). No RNG is consumed. Costs O(pending prompt
    # tokens) per resample — use when priorities must reflect realized
    # sharing, e.g. with prefix-sharing-aware scheduling enabled.
    exact_probe: bool = False
    # Incremental refresh: memoize the per-relQuery phase probe
    # (is_finished / all_waiting — each O(#requests)) against the scheduler's
    # ``RelQuery._phase_version`` counter, so a decode-heavy tick re-scores
    # only relQueries whose phase actually changed. Pure caching: priority
    # decisions are bit-identical with it on or off.
    incremental: bool = True


class DynamicPriorityUpdater:
    """Recomputes Prio(R_t) for every relQuery in the engine, each iteration."""

    def __init__(self, latency_model: BatchLatencyModel, limits: BatchLimits,
                 config: Optional[DPUConfig] = None):
        self.lm = latency_model
        self.limits = limits
        self.cfg = config or DPUConfig()
        # Optional ALISE-style output-length predictor (attached by the
        # scheduler): with history for a relQuery's template, PEM prices the
        # remaining decode phase at the predicted output length instead of
        # the OL(R) worst case. None = bit-identical to the unpredicted path.
        self.predictor = None
        self._rng = random.Random(self.cfg.seed)
        self._iteration = 0
        self._last_sampled: Dict[str, int] = {}
        # incremental-refresh memo: rel_id -> (phase_version, finished,
        # all_waiting) — valid while the scheduler hasn't bumped the version
        self._phase_memo: Dict[str, Tuple[int, bool, bool]] = {}
        # instrumentation
        self.stats = {"pem_calls": 0, "reuses": 0, "starvation_promotions": 0,
                      "sampled_requests": 0, "exact_probes": 0,
                      "phase_probes": 0, "phase_memo_hits": 0}

    def forget(self, rel_id: str) -> None:
        """Drop per-relQuery DPU state (used when a relQuery is cancelled)."""
        self._last_sampled.pop(rel_id, None)
        self._phase_memo.pop(rel_id, None)

    # ---------------------------------------------------------------- Eq. 11
    def _estimate_miss_ratio(self, rq: RelQuery, prefix_cache: Optional[PrefixCacheView]) -> float:
        if prefix_cache is None:
            return 1.0
        pending = rq.waiting_requests() + rq.preempted_requests()
        if not pending:
            return rq.cache_miss_ratio
        if self.cfg.exact_probe:
            return self._exact_miss_ratio(pending, prefix_cache)
        sample = pending if len(pending) <= self.cfg.sample_size else \
            self._rng.sample(pending, self.cfg.sample_size)
        tok = sum(r.num_prompt_tokens for r in sample)
        probe = getattr(prefix_cache, "peek_cached", prefix_cache.count_cached)
        cached = sum(probe(r.tokens) for r in sample)
        self.stats["sampled_requests"] += len(sample)
        return (tok - cached) / max(1, tok)

    def _exact_miss_ratio(self, pending: Sequence[Request],
                          prefix_cache: PrefixCacheView) -> float:
        """Full probe over every pending request, accumulating the warm set a
        warm-then-follow schedule will build: once any pending request has
        prefilled, its prompt blocks are hits for every later sibling — the
        realized sharing Eq. 11's sample-and-scale cannot see."""
        self.stats["exact_probes"] += 1
        self.stats["sampled_requests"] += len(pending)
        block_size = getattr(prefix_cache, "block_size", None)
        has_block = getattr(prefix_cache, "has_block", None)
        tok, cached = 0, 0
        if block_size is None or has_block is None:
            probe = getattr(prefix_cache, "peek_cached", prefix_cache.count_cached)
            for r in pending:
                tok += r.num_prompt_tokens
                cached += probe(r.tokens)
            return (tok - cached) / max(1, tok)
        from repro_torch.engine.prefix_cache import iter_block_hashes
        warm: set = set()
        for r in pending:
            tok += r.num_prompt_tokens
            keys = list(iter_block_hashes(r.tokens, block_size))
            for k in keys:
                if k in warm or has_block(k):
                    cached += block_size
                else:
                    break
            warm.update(keys)
        return (tok - cached) / max(1, tok)

    # ---------------------------------------------------------------- PEM (Eq. 10)
    def pem(self, rq: RelQuery) -> float:
        self.stats["pem_calls"] += 1
        ratio = rq.cache_miss_ratio
        waiting = rq.waiting_requests()
        preempted = rq.preempted_requests()
        utoks = [max(1, round(r.num_prompt_tokens * ratio)) for r in waiting]
        # Preempted requests restart with a re-prefill of prompt + generation
        # so far; the generated suffix is never prefix-cached. Pricing this
        # keeps Prio(R) honest after the memory subsystem evicts R's KV.
        utoks += [max(1, round(r.num_prompt_tokens * ratio))
                  + r.preserved_output_tokens for r in preempted]
        running = rq.running_requests()
        # Swapped requests resume decoding without re-prefill once their KV
        # returns from the host tier: they price like running requests (no
        # prefill batches, full membership in the decode phase).
        swapped = rq.swapped_requests()
        inflight = running + preempted + swapped
        # remaining decode iterations: not-yet-prefilled requests need the full
        # OL; otherwise only the longest-remaining in-flight request matters
        if waiting or not inflight:
            rem_out = rq.max_output_tokens
            if self.predictor is not None:
                pred = self.predictor.predict(self.predictor.key_of(rq))
                if pred is not None:   # predicted decode work, not worst case
                    rem_out = max(1, min(rem_out, pred))
        else:
            rem_out = max(r.remaining_output for r in inflight)
        batches = batch_decompose(utoks, rem_out,
                                  len(running) + len(swapped), self.limits)
        total = 0.0
        for b in batches:
            if b.kind == "prefill":
                total += self.lm.prefill_time(b.utok)
            else:
                total += self.lm.decode_time(b.reqs)
        return total

    # ---------------------------------------------------------------- Eq. 8 / 12 / 13
    def update(self, relqueries: Sequence[RelQuery], now: float,
               prefix_cache: Optional[PrefixCacheView] = None) -> None:
        self._iteration += 1
        for rq in relqueries:
            if self.cfg.incremental:
                ver = rq._phase_version
                memo = self._phase_memo.get(rq.rel_id)
                if memo is not None and memo[0] == ver:
                    self.stats["phase_memo_hits"] += 1
                    finished, all_waiting_now = memo[1], memo[2]
                else:
                    self.stats["phase_probes"] += 1
                    finished = rq.is_finished()
                    all_waiting_now = False if finished else rq.all_waiting()
                    self._phase_memo[rq.rel_id] = (ver, finished,
                                                   all_waiting_now)
                if finished:
                    continue
            else:
                if rq.is_finished():
                    continue
                all_waiting_now = rq.all_waiting()
            if all_waiting_now and rq._was_all_waiting and rq.priority_fresh:
                self.stats["reuses"] += 1            # Eq. 12: reuse Prio(R_{t-1})
            else:
                last = self._last_sampled.get(rq.rel_id, -10**9)
                if self._iteration - last >= self.cfg.resample_every or not rq.priority_fresh:
                    rq.cache_miss_ratio = self._estimate_miss_ratio(rq, prefix_cache)
                    self._last_sampled[rq.rel_id] = self._iteration
                rq.priority = self.pem(rq)
                rq.priority_fresh = True
            rq._was_all_waiting = all_waiting_now
            if (self.cfg.starvation_threshold is not None
                    and rq.first_prefill_start is None
                    and rq.unit_waiting_time(now) > self.cfg.starvation_threshold):
                rq.priority = 0.0                    # Eq. 13
                self.stats["starvation_promotions"] += 1


class StaticPriorityEstimator:
    """Baseline (vLLM-SP): Eq. 6/7 literally — ``ReqPrio(r) = L¹(tok(r)) +
    L²(OL(r))`` summed over requests, fixed at arrival. Like the static-priority
    works the paper cites, L¹/L² are simple per-request linear functions: no
    prefix-cache term, no batching model, no execution-progress updates."""

    def __init__(self, latency_model: BatchLatencyModel, limits: BatchLimits,
                 nominal_decode_batch: int = 32):
        self.lm = latency_model
        self.limits = limits
        self._l2_slope = self.lm.alpha_d + self.lm.beta_d / nominal_decode_batch

    def assign(self, rq: RelQuery) -> None:
        total = 0.0
        for r in rq.requests:
            total += self.lm.alpha_p * r.num_prompt_tokens          # L¹(tok(r))
            total += self._l2_slope * r.max_output_tokens           # L²(OL(r))
        rq.priority = total
        rq.priority_fresh = True
