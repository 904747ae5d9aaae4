"""Simulated-clock executor: executes scheduler-issued ``Batch``es against the
calibrated linear cost model (paper Fig. 7) and a *real* prefix cache, so the
scheduling decisions — the paper's subject — are identical to what the real
engine would issue, while batch durations come from the A100/OPT-13B-regime
constants (or any fitted model). Used by the paper-scale benchmarks.

One code path handles all batch kinds: the prefill side of a batch is a set of
(request, chunk) pairs — a pure prefill batch is simply the chunk covering the
whole remaining prompt — and the decode side decodes one token per request.
"""
from __future__ import annotations

import random
import zlib
from typing import Dict, Optional, Tuple

from repro_torch.core.batch import Batch
from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.relquery import Request
from repro_torch.core.scheduler import BatchResult
from repro_torch.engine.prefix_cache import PrefixCache


def sim_output_len(r: Request) -> int:
    """Actual (EOS-terminated) output length for simulation; defaults to OL."""
    return getattr(r, "sim_output_len", None) or r.max_output_tokens


def _content_key(r: Request) -> int:
    """Stable per-request stream seed derived from the *prompt content*, not
    the request identity: two requests with equal prompts emit identical
    streams, which is what makes the planner's exact-duplicate dedup
    answer-preserving (the leader's stream is bit-identical to what each
    duplicate would have produced alone). Memoized on the request."""
    key = getattr(r, "_sim_content_key", None)
    if key is None:
        key = zlib.crc32(",".join(map(str, r.tokens)).encode())
        r._sim_content_key = key
    return key


def sim_token(r: Request, produced: int) -> int:
    """The deterministic simulated token value for ``r``'s ``produced``-th
    output token (1-based). Single source of truth — tests pin streams
    against this exact formula."""
    return (zlib.crc32(f"{_content_key(r)}:{produced}".encode()) & 0x7FFF) + 2


def expected_stream(r: Request) -> list:
    """The full output stream the simulated executor will produce for ``r``
    (EOS replaces the final token when the request carries one)."""
    target = min(sim_output_len(r), r.max_output_tokens)
    toks = [sim_token(r, i) for i in range(1, target + 1)]
    if toks and r.eos_token is not None:
        toks[-1] = r.eos_token
    return toks


class SimulatedExecutor:
    # finish rule is the deterministic sim_output_len clamp — the pipelined
    # engine's finish prediction mirrors it exactly (speculation always hits)
    uses_sim_output_len = True

    def __init__(self, latency_model: BatchLatencyModel,
                 prefix_cache: Optional[PrefixCache] = None, seed: int = 0,
                 straggler_prob: float = 0.0, straggler_slowdown: float = 10.0,
                 hedge_threshold: Optional[float] = None,
                 swap_bandwidth_gbps: float = 32.0,
                 kv_bytes_per_token: int = 819_200):
        self.lm = latency_model
        self.prefix_cache = prefix_cache
        self._rng = random.Random(seed)
        self.total_prefill_tokens = 0
        self.total_uncached_tokens = 0
        self.total_decode_tokens = 0
        # host-tier swap model: moving a request's KV across the PCIe link
        # costs tokens * kv_bytes_per_token / bandwidth seconds, charged to
        # the tick that performs the swap (deterministic — no RNG)
        self.swap_bandwidth_bytes = swap_bandwidth_gbps * 1e9
        self.kv_bytes_per_token = kv_bytes_per_token
        self.swap_busy_s = 0.0          # seconds the channel actually moved bytes
        self.swap_bytes_total = 0.0     # invariant: busy_s * bandwidth == bytes
        # shared-bandwidth budget: one device<->host channel, FIFO. Absolute
        # sim time the channel frees up (prefetch copies queued in earlier
        # ticks keep it busy across tick boundaries), and the per-tick charge
        # ledger (seconds of swap stall this tick's ops billed the engine).
        self._channel_free_at = 0.0
        self._tick_now: Optional[float] = None
        self._tick_charged_s = 0.0
        # req_id -> absolute time its prefetched host->device copy completes
        self._prefetch_done: Dict[str, float] = {}
        self.prefetch_issues = 0
        self.prefetch_hits = 0          # commits whose copy had fully landed
        self.prefetch_cancels = 0
        # straggler-mitigation model: with straggler_prob a batch takes
        # slowdown x nominal; with hedging, a duplicate dispatch to a healthy
        # DP replica bounds the wait at threshold x nominal + nominal.
        self.straggler_prob = straggler_prob
        self.straggler_slowdown = straggler_slowdown
        self.hedge_threshold = hedge_threshold
        self.stragglers_seen = 0
        self.hedges_fired = 0

    def _apply_straggler(self, duration: float) -> float:
        if self.straggler_prob <= 0 or self._rng.random() >= self.straggler_prob:
            return duration
        self.stragglers_seen += 1
        slow = duration * self.straggler_slowdown
        if self.hedge_threshold is not None:
            self.hedges_fired += 1
            return min(slow, duration * self.hedge_threshold + duration)
        return slow

    # ------------------------------------------------------------------
    # KV-tiering swap hooks (engine-drained): the simulated device has no
    # buffers to copy, so a swap is pure modeled transfer time, priced by a
    # shared-bandwidth queue — concurrent ops serialize on one channel, so a
    # tick's k-th swap queues behind the first k-1 and any still-running
    # prefetch copy. With the channel free at tick start this degenerates to
    # the per-op full-bandwidth price (each op charged exactly bytes/budget),
    # bit-identical to the pre-budget model.
    def _horizon(self) -> float:
        """When this tick's already-billed swap stall ends — the point a new
        op's wait is measured from (the engine serializes billed charges)."""
        return (self._tick_now or 0.0) + self._tick_charged_s

    def begin_swap_tick(self, now: float) -> None:
        """Engine hook: called before a tick's swap ops are mirrored. Resets
        the per-tick charge ledger; the channel-free clock persists across
        ticks (a prefetch issued last tick may still occupy the link)."""
        if now != self._tick_now:
            self._tick_now = now
            self._tick_charged_s = 0.0

    def _charge(self, nbytes: float) -> float:
        """Queue a synchronous (engine-blocking) transfer on the channel and
        return the stall it bills this tick: wait-for-channel + transfer.
        Never less than the raw transfer time, never negative."""
        dur = nbytes / self.swap_bandwidth_bytes
        horizon = self._horizon()
        end = max(horizon, self._channel_free_at) + dur
        self._channel_free_at = end
        charge = end - horizon
        self._tick_charged_s += charge
        self.swap_busy_s += dur
        self.swap_bytes_total += nbytes
        return charge

    def swap_out(self, req_id: str, tokens: int) -> float:
        return self._charge(tokens * self.kv_bytes_per_token)

    def swap_in(self, req_id: str, tokens: int) -> float:
        done = self._prefetch_done.pop(req_id, None)
        if done is None:
            return self._charge(tokens * self.kv_bytes_per_token)
        # prefetched commit: the copy was queued (and its bytes accounted)
        # when issued; the commit only bills whatever tail of it hasn't
        # landed yet. A fully-landed copy is a zero-stall resume.
        charge = max(0.0, done - self._horizon())
        if charge == 0.0:
            self.prefetch_hits += 1
        self._tick_charged_s += charge
        return charge

    def prefetch_swap_in(self, req_id: str, tokens: int) -> float:
        """Issue a request's host->device copy ahead of its swap-in commit.
        The copy queues on the shared channel and rides under compute — the
        issuing tick is billed nothing; the commit bills only the un-landed
        tail (usually zero by the time it fires)."""
        if req_id in self._prefetch_done:
            return 0.0
        nbytes = tokens * self.kv_bytes_per_token
        dur = nbytes / self.swap_bandwidth_bytes
        start = max(self._horizon(), self._channel_free_at)
        self._channel_free_at = start + dur
        self._prefetch_done[req_id] = start + dur
        self.prefetch_issues += 1
        self.swap_busy_s += dur
        self.swap_bytes_total += nbytes
        return 0.0

    def cancel_swap_prefetch(self, req_id: str, tokens: int) -> float:
        """Abort a staged prefetch (request cancelled before commit). The
        un-copied remainder is refunded to the channel — bytes that never
        moved must not count as moved — when the copy is still the channel's
        tail; a copy another op already queued behind is sunk cost."""
        done = self._prefetch_done.pop(req_id, None)
        if done is None:
            return 0.0
        self.prefetch_cancels += 1
        dur = tokens * self.kv_bytes_per_token / self.swap_bandwidth_bytes
        if self._channel_free_at == done:
            new_free = max(min(self._horizon(), done), done - dur)
            refund = done - new_free
            self._channel_free_at = new_free
            self.swap_busy_s -= refund
            self.swap_bytes_total -= refund * self.swap_bandwidth_bytes
        return 0.0

    def swap_ledger(self) -> Dict[str, float]:
        """Audit view of the bandwidth budget — tests assert conservation
        (busy seconds x budget == bytes moved; both non-negative)."""
        return {
            "busy_s": self.swap_busy_s,
            "bytes": self.swap_bytes_total,
            "tick_charged_s": self._tick_charged_s,
            "channel_free_at": self._channel_free_at,
            "prefetch_issues": self.prefetch_issues,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_cancels": self.prefetch_cancels,
        }

    # ------------------------------------------------------------------
    def _true_utok(self, r: Request, chunk: int) -> int:
        """Uncached tokens of the ``chunk`` next prompt tokens of ``r`` —
        prefix-cache savings apply to the front of the prompt (for a preempted
        request's restart, the prompt + preserved generation). Only the first
        chunk of a prefill pass probes with stats: one stats-bearing lookup
        per pass keeps hits+misses equal to the prompt tokens actually looked
        up, instead of inflating once per chunk."""
        seq = r.prefill_token_ids()
        if self.prefix_cache is None:
            n_cached = 0
        elif r.prefilled_tokens == 0:
            n_cached = self.prefix_cache.count_cached(seq)
        else:
            n_cached = self.prefix_cache.peek_cached(seq)
        done = r.prefilled_tokens
        return max(0, min(done + chunk, r.prefill_target_tokens)
                   - max(done, n_cached))

    def _token_for(self, r: Request) -> Tuple[int, bool]:
        produced = len(r.output_tokens) + 1
        target = min(sim_output_len(r), r.max_output_tokens)
        finished = produced >= target
        token = sim_token(r, produced)
        if finished and r.eos_token is not None:
            token = r.eos_token
        return token, finished

    # ------------------------------------------------------------------
    def execute(self, batch: Batch, now: float) -> Tuple[float, BatchResult]:
        outputs: Dict[str, Tuple[int, bool]] = {}
        utok = 0
        for r in batch.prefill_requests:
            chunk = batch.chunk_of(r)
            utok += self._true_utok(r, chunk)
            self.total_prefill_tokens += chunk
            if batch.completes_prompt(r):
                if self.prefix_cache is not None:
                    # only the *prompt* enters the prefix cache: generated
                    # tokens are never prefix-cached, the invariant the utok
                    # estimator and PEM's re-prefill pricing rely on
                    self.prefix_cache.insert(r.tokens)
                outputs[r.req_id] = self._token_for(r)
        for r in batch.decode_requests:
            outputs[r.req_id] = self._token_for(r)
        self.total_uncached_tokens += utok
        self.total_decode_tokens += len(batch.decode_requests)
        dur = self._apply_straggler(batch.cost(self.lm, true_uncached=utok))
        return dur, BatchResult(outputs, uncached_tokens=utok if
                                batch.prefill_requests else None)

    # ------------------------------------------------------------------
    # Split dispatch/wait contract (pipelined engine loop): the simulated
    # clock has no device to overlap with, so ``dispatch`` computes the whole
    # batch synchronously and ``wait`` just hands the result back. Durations
    # are model-computed either way, so pipelined simulated runs stay
    # bit-identical to serial ones while still exercising the engine's
    # speculate/reconcile machinery.
    def dispatch(self, batch: Batch, now: float) -> Tuple[float, BatchResult]:
        return self.execute(batch, now)

    def wait(self, inflight: Tuple[float, BatchResult]) -> Tuple[float, BatchResult]:
        return inflight
