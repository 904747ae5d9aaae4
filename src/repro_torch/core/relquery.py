"""relQuery workload model (paper §2.1, Definitions 2.1 & 2.2).

A relQuery R = relQuery(T, ζ) instantiates one request per table row by
substituting row values into the task template ζ. All requests of R share one
latency: R completes when its last request completes.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"    # prefilled; decoding
    PREEMPTED = "preempted"  # KV reclaimed under pressure; awaiting re-prefill
    SWAPPED = "swapped"    # KV parked on the host tier; resumes w/o re-prefill
    FINISHED = "finished"
    CANCELLED = "cancelled"  # terminal: evicted by relQuery cancellation


@dataclass
class Request:
    """One LLM request r = ζ[s_i] (token ids already rendered)."""

    rel_id: str
    tokens: Tuple[int, ...]            # prompt token ids
    max_output_tokens: int             # OL(R)
    req_id: str = field(default_factory=lambda: f"r{next(_req_counter)}")
    eos_token: Optional[int] = None

    # --- runtime state (owned by the scheduler) ---
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = field(default_factory=list)
    prefilled: bool = False
    prefilled_tokens: int = 0          # chunked-prefill progress (Sarathi)
    finish_time: Optional[float] = None
    # Output tokens generated before the last preemption. A preempted request
    # restarts recompute-style: its next prefill pass re-loads the prompt plus
    # these preserved tokens (they are kept in ``output_tokens``), then decode
    # resumes from where it left off.
    preserved_output_tokens: int = 0

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.tokens)

    @property
    def prefill_target_tokens(self) -> int:
        """Tokens the next prefill pass must load into KV: the prompt, plus —
        after a preemption — the generated tokens being recomputed."""
        return self.num_prompt_tokens + self.preserved_output_tokens

    def prefill_token_ids(self) -> Tuple[int, ...]:
        """The token sequence a prefill pass computes over (prompt, or prompt
        + preserved generation for a preempted request's restart)."""
        if not self.preserved_output_tokens:
            return tuple(self.tokens)
        return tuple(self.tokens) + \
            tuple(self.output_tokens[:self.preserved_output_tokens])

    @property
    def remaining_output(self) -> int:
        return max(0, self.max_output_tokens - len(self.output_tokens))

    @property
    def total_tokens(self) -> int:
        return self.num_prompt_tokens + len(self.output_tokens)

    def is_finished(self) -> bool:
        return self.state == RequestState.FINISHED

    def is_terminal(self) -> bool:
        """Finished or cancelled: this request will never be scheduled again."""
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED)


@dataclass
class RelQuery:
    """A set of requests sharing one user-facing latency (Definition 2.1)."""

    rel_id: str
    requests: List[Request]
    arrival_time: float
    max_output_tokens: int             # OL(R): shared output-length limit
    template_id: str = ""

    # --- latency phase bookkeeping (Definition 2.2) ---
    first_prefill_start: Optional[float] = None
    last_prefill_end: Optional[float] = None
    finish_time: Optional[float] = None
    cancel_time: Optional[float] = None    # terminal: set once by cancellation

    # --- scheduling state ---
    priority: float = 0.0
    priority_fresh: bool = False       # was recomputed this iteration
    _was_all_waiting: bool = False     # Eq. 12 reuse predicate memo
    cache_miss_ratio: float = 1.0      # sampled utok*/tok estimate (Eq. 11)
    preemptions: int = 0               # times any request of R was preempted
    # Parked relQueries hold results another stage is waiting on (a derive
    # stage blocked on upstream DAG output, or a tool-call suspension): their
    # device KV is idle until whoever parked them unparks them. A tiering
    # scheduler with proactive offload treats their RUNNING requests as
    # first-class swap-out victims and will not swap them back in while
    # parked. Parking only affects KV placement — it does not cancel, finish,
    # or reorder the relQuery.
    parked: bool = False
    # Monotone counter bumped by the scheduler whenever any request of R
    # changes state (prefill finish, decode finish, preemption, cancel,
    # speculative rollback). The DPU's incremental refresh memoizes its
    # O(#requests) phase probe (``all_waiting``) against this version, so a
    # decode-heavy tick re-scores only relQueries whose phase actually moved.
    _phase_version: int = 0

    def __post_init__(self):
        for r in self.requests:
            r.rel_id = self.rel_id
            if r.max_output_tokens <= 0:
                r.max_output_tokens = self.max_output_tokens

    # ------------------------------------------------------------------
    def note_phase_change(self) -> None:
        """Invalidate memoized phase probes. Any code that flips a request's
        ``state`` (or finishes/cancels this relQuery) outside the scheduler's
        own transition methods must call this, or the DPU's incremental
        refresh will keep serving the stale phase."""
        self._phase_version += 1

    @property
    def num_requests(self) -> int:
        return len(self.requests)

    def active_requests(self) -> List[Request]:
        """R_t: requests not yet finished (or cancelled)."""
        return [r for r in self.requests if not r.is_terminal()]

    @property
    def cancelled(self) -> bool:
        return self.cancel_time is not None

    def waiting_requests(self) -> List[Request]:
        return [r for r in self.requests if r.state == RequestState.WAITING]

    def running_requests(self) -> List[Request]:
        return [r for r in self.requests if r.state == RequestState.RUNNING]

    def preempted_requests(self) -> List[Request]:
        return [r for r in self.requests if r.state == RequestState.PREEMPTED]

    def swapped_requests(self) -> List[Request]:
        return [r for r in self.requests if r.state == RequestState.SWAPPED]

    def is_finished(self) -> bool:
        return all(r.is_finished() for r in self.requests)

    def all_waiting(self) -> bool:
        return all(r.state == RequestState.WAITING for r in self.requests
                   if not r.is_finished()) and not self.is_finished()

    def remaining_workload_ratio(self) -> float:
        """Fraction of total token workload still to process (Fig. 3)."""
        total = sum(r.num_prompt_tokens + r.max_output_tokens for r in self.requests)
        done = sum((r.num_prompt_tokens if r.prefilled else 0) + len(r.output_tokens)
                   for r in self.requests)
        return 1.0 - done / max(1, total)

    # ------------------------------------------------------------------ metrics
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def waiting_time(self) -> Optional[float]:
        if self.first_prefill_start is None:
            return None
        return self.first_prefill_start - self.arrival_time

    def core_running_time(self) -> Optional[float]:
        if self.first_prefill_start is None or self.last_prefill_end is None:
            return None
        return self.last_prefill_end - self.first_prefill_start

    def tail_running_time(self) -> Optional[float]:
        if self.last_prefill_end is None or self.finish_time is None:
            return None
        return self.finish_time - self.last_prefill_end

    def unit_waiting_time(self, now: float) -> float:
        """Eq. 13 fairness metric: waiting time normalized by request count."""
        start = self.first_prefill_start if self.first_prefill_start is not None else now
        return max(0.0, start - self.arrival_time) / max(1, self.num_requests)


def make_relquery(rel_id: str, prompts: Sequence[Sequence[int]], arrival: float,
                  max_output_tokens: int, template_id: str = "",
                  eos_token: Optional[int] = None) -> RelQuery:
    reqs = [Request(rel_id=rel_id, tokens=tuple(p), max_output_tokens=max_output_tokens,
                    eos_token=eos_token) for p in prompts]
    return RelQuery(rel_id=rel_id, requests=reqs, arrival_time=arrival,
                    max_output_tokens=max_output_tokens, template_id=template_id)
