"""Workload-level rewrite passes (Berkeley "Optimizing LLM Queries in
Relational Workloads"): rule-based rewrites over a stage's *request list*
that cut cost before the scheduler ever sees the work.

All passes are answer-preserving by construction:

* ``dedup_requests`` — exact-duplicate elimination. Two requests are
  duplicates only when *everything* that determines their token stream is
  equal: prompt token ids, output limit, EOS id and (for simulated traces)
  the EOS-terminated ``sim_output_len``. The first occurrence becomes the
  *leader* (the one physical request); followers are answered by fan-out —
  the executors are content-deterministic, so the leader's stream is
  bit-identical to what each follower would have produced alone.
* ``reorder_requests`` — prefix-maximizing row reorder: a stable sort by
  prompt token sequence, so rows sharing a prompt prefix (same template, same
  shared column values) become adjacent. The PR-4 warm-then-follow scheduler
  and the ``SharedPrefixLedger`` then see maximal leader→follower chains, and
  the plain LRU prefix cache sees hits before eviction. A permutation: no
  request is lost or duplicated (property-tested).
* ``project_rows`` — column projection: drop every column the template never
  references, *before* dedup keys are built. Rows that differ only in unused
  columns (a row_id, say) render identical prompts, so projection is what
  lets dedup see through incidental per-row noise. Referenced-but-missing
  columns are not silently tolerated — ``RelQueryTemplate.render`` raises.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

from repro_torch.core.relquery import Request
from repro_torch.data.templates import RelQueryTemplate

FanoutMap = Dict[str, List[Request]]   # leader req_id -> follower Requests


def request_identity(r: Request) -> Hashable:
    """The dedup key: every request property that determines its output
    stream. ``sim_output_len`` is included because simulated traces terminate
    generation at that (per-request) length — two rows with equal prompts but
    different sampled EOS points are *not* exact duplicates."""
    return (r.tokens, r.max_output_tokens, r.eos_token,
            getattr(r, "sim_output_len", None))


def dedup_requests(requests: Sequence[Request]) -> Tuple[List[Request], FanoutMap]:
    """Exact-duplicate dedup: returns (leaders in first-occurrence order,
    leader req_id -> follower requests). Leaders are the original ``Request``
    objects — they carry their outputs natively; followers receive copies at
    fan-out time."""
    leaders: List[Request] = []
    by_key: Dict[Hashable, Request] = {}
    fanout: FanoutMap = {}
    for r in requests:
        key = request_identity(r)
        leader = by_key.get(key)
        if leader is None:
            by_key[key] = r
            leaders.append(r)
            fanout[r.req_id] = []
        else:
            fanout[leader.req_id].append(r)
    return leaders, {k: v for k, v in fanout.items() if v}


def reorder_requests(requests: Sequence[Request]) -> List[Request]:
    """Prefix-maximizing row reorder: stable sort by prompt token sequence
    (prefix-lexicographic — rows sharing the longest prompt prefixes become
    neighbours). Stability keeps the original order among exact ties, so the
    result is always a permutation of the input."""
    return sorted(requests, key=lambda r: r.tokens)


def project_rows(rows: Sequence[Dict[str, str]],
                 template: RelQueryTemplate) -> List[Dict[str, str]]:
    """Project each row onto the columns the template references. Missing
    referenced columns are kept missing (``render`` raises a clear KeyError
    naming the template and attribute — the planner depends on accurate
    attribute extraction, not on silent empty substitution)."""
    attrs = template.attributes
    return [{a: row[a] for a in attrs if a in row} for row in rows]
