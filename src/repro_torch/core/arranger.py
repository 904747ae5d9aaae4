"""Adaptive Batch Arranger (paper §4.3, Eq. 14-17), generalized to a
multi-candidate choice over unified ``Batch`` objects.

The scheduler hands ABA a *list* of candidate batches for this iteration —
typically the candidate decode batch (all running requests), the candidate
prefill batch (head of the priority-ordered waiting queue), and a
chunked-mixed candidate (running requests decode while a prompt chunk of the
head waiting request prefills in the same pass). ABA picks one:

- m⁺ > m⁻  → *preemption*: a shorter relQuery is waiting; start it (prefill).
- m⁺ = m⁻  → *internal*: same relQuery on both sides; prefill first to
             maximize the eventual combined decode batch.
- m⁺ < m⁻  → *transitional*: the running relQuery finished its prefills; price
             the latency trade-off Δ = Δ⁺ + Δ⁻ for every prefill-side
             candidate (pure and chunked-mixed) and run the cheapest when its
             Δ < 0, else decode.

Chunked-mixed candidates extend Eq. 15/16: the running requests still decode
inside a mixed pass, so Δ⁺ only charges the *incremental* compute
``L_mixed(utok, d) − L_decode(d)`` per running relQuery, and only chunks that
complete their prompt contribute newcomers to future decode batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

from repro_torch.core.batch import Batch
from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.relquery import RelQuery


@dataclass
class ArrangerDecision:
    kind: str          # 'prefill' | 'decode' | 'mixed'
    case: str          # 'preempt' | 'internal' | 'transitional' | 'forced'
    delta: Optional[float] = None


class AdaptiveBatchArranger:
    def __init__(self, latency_model: BatchLatencyModel):
        self.lm = latency_model
        self.stats = {"preempt": 0, "internal": 0, "transitional_prefill": 0,
                      "transitional_mixed": 0, "transitional_decode": 0,
                      "forced": 0, "warm_follow": 0}

    def _done(self, decision: ArrangerDecision, by_kind) -> ArrangerDecision:
        """Count wins of warm-then-follow candidates: prefill-side batches
        whose ``uncached_tokens`` was discounted by intra-batch prefix reuse
        — the reuse ABA saw through ``Batch.cost``."""
        cand = by_kind.get(decision.kind)
        if cand is not None and cand.shared_prefix_tokens > 0:
            self.stats["warm_follow"] += 1
        return decision

    def choose(
        self,
        candidates: Iterable[Optional[Batch]],
        running_rqs: Sequence[RelQuery],      # R_t^+
        waiting_rqs: Sequence[RelQuery],      # R_t^-
        prio_of,                              # Request -> priority value
        now: float = 0.0,
    ) -> ArrangerDecision:
        by_kind = {}
        for c in candidates:
            if c is not None and not c.is_empty():
                by_kind[c.kind] = c
        if not by_kind:
            raise ValueError("no candidates — engine should idle instead")

        d_cand = by_kind.get("decode")
        prefill_side = [by_kind[k] for k in ("prefill", "mixed") if k in by_kind]
        if d_cand is None:
            self.stats["forced"] += 1
            return self._done(ArrangerDecision(prefill_side[0].kind, "forced"),
                              by_kind)
        if not prefill_side:
            self.stats["forced"] += 1
            return ArrangerDecision("decode", "forced")

        m_plus = d_cand.min_priority(prio_of)
        m_minus = min(c.min_prefill_priority(prio_of) for c in prefill_side)
        if m_plus >= m_minus:
            # preemption / internal: a relQuery at least as urgent as everything
            # running is waiting — start it with a full prefill when available.
            case = "preempt" if m_plus > m_minus else "internal"
            self.stats[case] += 1
            return self._done(ArrangerDecision(prefill_side[0].kind, case),
                              by_kind)

        # transitional: price every prefill-side candidate, take the cheapest.
        best, best_delta = None, None
        for c in prefill_side:
            delta = self.delta_latency(c, running_rqs, waiting_rqs)
            if best_delta is None or delta < best_delta:
                best, best_delta = c, delta
        if best_delta < 0:
            self.stats[f"transitional_{best.kind}"] += 1
            return self._done(
                ArrangerDecision(best.kind, "transitional", best_delta), by_kind)
        self.stats["transitional_decode"] += 1
        return ArrangerDecision("decode", "transitional", best_delta)

    # ------------------------------------------------------------- Eq. 15-17
    def delta_latency(self, cand: Batch, running_rqs: Sequence[RelQuery],
                      waiting_rqs: Sequence[RelQuery]) -> float:
        """Projected total-latency change of executing ``cand`` before the
        candidate decode batch. Handles pure-prefill and chunked-mixed."""
        lm = self.lm
        preqs = cand.prefill_requests
        ol_p = cand.relquery.max_output_tokens if cand.relquery else \
            max((r.max_output_tokens for r in preqs), default=0)
        completing = [r for r in preqs if cand.completes_prompt(r)]

        rem_out = {rq.rel_id: max((r.remaining_output for r in rq.running_requests()),
                                  default=0) for rq in running_rqs}
        if cand.kind == "mixed":
            # running requests decode inside the mixed pass: they only pay the
            # incremental chunk compute, and only completing chunks add
            # newcomers to their future decode batches.
            n_d = len(cand.decode_requests)
            stall = lm.mixed_time(cand.uncached_tokens, n_d) - lm.decode_time(n_d)
            joiners = len(completing)
        else:
            # Δ⁺ (Eq. 15): every running relQuery is delayed by the prefill
            # pass and by the larger decode batches it will share.
            stall = lm.prefill_time(cand.uncached_tokens)
            joiners = len(completing)
        delta_plus = stall * len(running_rqs)
        delta_plus += sum(lm.alpha_d * joiners * min(rem_out[rq.rel_id], ol_p)
                          for rq in running_rqs)

        # Δ⁻ (Eq. 16): waiting relQueries gain from combined decoding — every
        # decode iteration the newcomer shares with a running relQuery is one
        # batch overhead β_d the queue does not pay twice. For mixed batches
        # only the completing fraction of the chunked requests joins decode now.
        max_run_out = max([rem_out[rq.rel_id] for rq in running_rqs], default=0)
        share = 1.0 if cand.kind != "mixed" else \
            len(completing) / max(1, len(preqs))
        delta_minus = -len(waiting_rqs) * lm.beta_d * min(ol_p, max_run_out) * share
        return delta_plus + delta_minus
