"""The one batch abstraction shared by schedulers, the arranger and executors.

A ``Batch`` is simultaneously an ABA *candidate* (something the Adaptive Batch
Arranger can price with ``cost()``/its Δ-latency projection) and a *scheduled*
unit of work (something an executor runs and ``complete_batch`` retires).
Before this type existed the repo carried a ``CandidateBatch``/
``ScheduledBatch`` duality and the RelServe scheduler structurally could not
emit the chunked/mixed batches the executors already understood; unifying the
type makes chunked-prefill arrangement a first-class ABA case.

Kinds:
- ``prefill``: prefill ``prefill_requests`` fully (their whole remaining
  prompt); ``uncached_tokens`` is the *estimated* uncached-token compute.
- ``decode``: one decode step over ``decode_requests``.
- ``mixed``: Sarathi-style chunked prefill — decode ``decode_requests`` one
  token while ``prefill_chunks[req_id]`` prompt tokens of each request in
  ``prefill_requests`` are prefilled in the same pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.relquery import RelQuery, Request

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a circular import
    from repro_torch.core.arranger import ArrangerDecision

BATCH_KINDS = ("prefill", "decode", "mixed")


@dataclass
class Batch:
    kind: str                                               # one of BATCH_KINDS
    prefill_requests: List[Request] = field(default_factory=list)
    decode_requests: List[Request] = field(default_factory=list)
    prefill_chunks: Dict[str, int] = field(default_factory=dict)  # req_id -> len
    uncached_tokens: int = 0           # estimated utok of the prefill side
    # estimated prefill tokens this batch saves through *intra-batch* prefix
    # reuse (warm-then-follow: followers priced at the post-leader hit rate);
    # already subtracted from uncached_tokens, carried for instrumentation
    shared_prefix_tokens: int = 0
    relquery: Optional[RelQuery] = None  # single-relQuery prefill candidates
    decision: Optional["ArrangerDecision"] = None

    def __post_init__(self):
        if self.kind not in BATCH_KINDS:
            raise ValueError(f"unknown batch kind {self.kind!r}")

    # ------------------------------------------------------------------ views
    @property
    def requests(self) -> List[Request]:
        """Legacy view: the batch's primary request list (prefill targets, or
        the decode requests for a pure-decode batch)."""
        return self.decode_requests if self.kind == "decode" else self.prefill_requests

    @property
    def num_requests(self) -> int:
        return len(self.prefill_requests) + len(self.decode_requests)

    def all_requests(self) -> List[Request]:
        return self.prefill_requests + self.decode_requests

    def rel_ids(self) -> Tuple[str, ...]:
        # sorted: str-set iteration order is hash-salted, and event logs must
        # be reproducible across processes
        return tuple(sorted({r.rel_id for r in self.all_requests()}))

    def is_empty(self) -> bool:
        return not self.prefill_requests and not self.decode_requests

    def chunk_of(self, r: Request) -> int:
        """Prompt tokens this batch prefills for ``r``: the scheduled chunk, or
        the whole remaining prompt (prompt + preserved generation for a
        preempted request's restart) for non-chunked prefill."""
        default = r.prefill_target_tokens - r.prefilled_tokens
        return self.prefill_chunks.get(r.req_id, default)

    def completes_prompt(self, r: Request) -> bool:
        return r.prefilled_tokens + self.chunk_of(r) >= r.prefill_target_tokens

    def min_priority(self, prio_of) -> float:
        return min(prio_of(r) for r in self.all_requests())

    def min_prefill_priority(self, prio_of) -> float:
        reqs = self.prefill_requests or self.decode_requests
        return min(prio_of(r) for r in reqs)

    # ------------------------------------------------------------------ cost
    def cost(self, lm: BatchLatencyModel,
             true_uncached: Optional[int] = None) -> float:
        """Predicted duration under the linear batch-cost model (Eq. 9).
        ``true_uncached`` lets an executor substitute the measured uncached
        token count for the scheduler's estimate."""
        utok = self.uncached_tokens if true_uncached is None else true_uncached
        if self.kind == "prefill":
            return lm.prefill_time(utok)
        if self.kind == "decode":
            return lm.decode_time(len(self.decode_requests))
        return lm.mixed_time(utok, len(self.decode_requests))

    # ------------------------------------------------------------------ makers
    @classmethod
    def prefill(cls, requests: List[Request], uncached_tokens: int = 0,
                relquery: Optional[RelQuery] = None,
                shared_prefix_tokens: int = 0) -> "Batch":
        return cls("prefill", prefill_requests=list(requests),
                   uncached_tokens=uncached_tokens, relquery=relquery,
                   shared_prefix_tokens=shared_prefix_tokens)

    @classmethod
    def decode(cls, requests: List[Request]) -> "Batch":
        return cls("decode", decode_requests=list(requests))

    @classmethod
    def mixed(cls, prefill_requests: List[Request], decode_requests: List[Request],
              chunks: Dict[str, int], uncached_tokens: int = 0,
              shared_prefix_tokens: int = 0) -> "Batch":
        return cls("mixed", prefill_requests=list(prefill_requests),
                   decode_requests=list(decode_requests),
                   prefill_chunks=dict(chunks), uncached_tokens=uncached_tokens,
                   shared_prefix_tokens=shared_prefix_tokens)


# --------------------------------------------------------------------------
# Back-compat aliases (pre-unification API). New code should construct Batch
# directly; these keep the old constructor signatures working for callers
# that update their import to this module (the old homes in core.scheduler /
# core.arranger no longer export the names).
# --------------------------------------------------------------------------
def CandidateBatch(requests: List[Request], uncached_tokens: int = 0,
                   relquery: Optional[RelQuery] = None) -> Batch:
    """Legacy constructor: an arranger candidate (was a distinct dataclass)."""
    return Batch.prefill(requests, uncached_tokens, relquery)


def ScheduledBatch(kind: str, requests: List[Request], uncached_tokens: int = 0,
                   decode_requests: Optional[List[Request]] = None,
                   prefill_chunks: Optional[Dict[str, int]] = None,
                   decision: Optional["ArrangerDecision"] = None) -> Batch:
    """Legacy constructor: a scheduler-issued batch (was a distinct dataclass)."""
    if kind == "decode":
        b = Batch.decode(requests)
    else:
        b = Batch(kind, prefill_requests=list(requests),
                  decode_requests=list(decode_requests or []),
                  prefill_chunks=dict(prefill_chunks or {}),
                  uncached_tokens=uncached_tokens)
    b.decision = decision
    return b
