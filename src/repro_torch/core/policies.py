"""Baseline scheduling policies (paper §5.1 baselines + §5.3 ablations).

- ``VLLMScheduler``      — FCFS arrival order, strict prefill prioritization.
- ``SarathiScheduler``   — FCFS + chunked prefill mixed with decode (one
  ``build_mixed_candidate`` batch per iteration).
- ``StaticPriorityScheduler`` (vLLM-SP) — Eq. 6/7 priority fixed at arrival,
  prefill prioritization; same code base as RelServe minus DPU/ABA.
- ``RelServePP`` / ``RelServeDP`` — RelServe with the transitional-case
  arrangement pinned to prefill-first / decode-first (Fig. 10 ablation).

All policies emit the unified ``repro_torch.core.batch.Batch``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.batch import Batch
from repro_torch.core.priority import StaticPriorityEstimator
from repro_torch.core.relquery import RelQuery, Request
from repro_torch.core.scheduler import RelServeScheduler, SchedulerBase


class VLLMScheduler(SchedulerBase):
    """FCFS + prefill-first (vLLM default). Prefill batches may mix relQueries
    — vLLM has no relQuery awareness."""

    name = "vllm"

    def rq_sort_key(self, rq: RelQuery):
        return (rq.arrival_time, rq.rel_id)

    def choose_batch(self, now: float) -> Optional[Batch]:
        p_cand = self.build_prefill_candidate(single_relquery=False)
        if p_cand is not None:
            return p_cand
        return self.build_decode_candidate()

    def estimated_utok(self, r: Request) -> int:
        # FCFS baselines still benefit from the engine prefix cache at
        # *execution* time; for batch construction they use full token counts
        # (vLLM packs prefill batches by prompt length).
        return r.num_prompt_tokens


class StaticPriorityScheduler(SchedulerBase):
    """vLLM-SP: static priority assigned once at arrival (Eq. 6/7)."""

    name = "vllm_sp"

    def __init__(self, limits=None, latency_model=None, prefix_cache=None,
                 kv_admission: str = "conservative",
                 prefix_sharing: bool = False, **kw):
        super().__init__(limits, latency_model, prefix_cache, kv_admission,
                         prefix_sharing, **kw)
        self.estimator = StaticPriorityEstimator(self.lm, self.limits)

    def on_relquery_added(self, rq: RelQuery, now: float) -> None:
        self.estimator.assign(rq)

    def choose_batch(self, now: float) -> Optional[Batch]:
        p_cand = self.build_prefill_candidate(single_relquery=True)
        if p_cand is not None:
            return p_cand
        return self.build_decode_candidate()


class SarathiScheduler(SchedulerBase):
    """FCFS + chunked prefill: every iteration runs one *mixed* batch — all
    running requests decode one token while a chunk of the head waiting
    request's prompt is prefilled, sharing the token budget."""

    name = "sarathi"

    def rq_sort_key(self, rq: RelQuery):
        return (rq.arrival_time, rq.rel_id)

    def choose_batch(self, now: float) -> Optional[Batch]:
        return self.build_mixed_candidate(single_relquery=False)


class RelServePP(RelServeScheduler):
    """Ablation: RelServe priorities, transitional case pinned to prefill."""
    name = "relserve_pp"
    arrangement = "prefill_first"


class RelServeDP(RelServeScheduler):
    """Ablation: RelServe priorities, transitional case pinned to decode."""
    name = "relserve_dp"
    arrangement = "decode_first"


SCHEDULERS = {
    "vllm": VLLMScheduler,
    "sarathi": SarathiScheduler,
    "vllm_sp": StaticPriorityScheduler,
    "relserve": RelServeScheduler,
    "relserve_pp": RelServePP,
    "relserve_dp": RelServeDP,
}


def build_scheduler(name: str, **kw) -> SchedulerBase:
    return SCHEDULERS[name](**kw)
