"""The planner: applies rewrite passes to plan nodes / trace relQueries,
producing ``PlannedQuery`` units the ``PlanExecutor`` submits.

``mode`` selects the pass pipeline (mirrors ``launch/serve.py --plan``):

==========  ==========================================================
``off``     no rewrite — the physical relQuery *is* the logical one
``dedup``   projection + exact-duplicate dedup (answer once, fan out)
``reorder`` projection + prefix-maximizing row reorder
``full``    projection + dedup + reorder
==========  ==========================================================

Planning wall-clock accumulates in ``Planner.plan_time`` so the overhead is
visible in reports next to schedule/dpu time (``ServiceReport.plan_time``).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.relquery import RelQuery, Request, make_relquery
from repro_torch.data.templates import RelQueryTemplate
from repro_torch.engine.tokenizer import HashTokenizer
from repro_torch.planner.passes import (FanoutMap, dedup_requests, project_rows,
                                  reorder_requests)
from repro_torch.planner.plan import PlanNode

PLAN_MODES = ("off", "dedup", "reorder", "full")


@dataclass
class PlannedQuery:
    """One plan stage, compiled: the logical per-row view plus the physical
    relQuery actually submitted.

    ``logical_requests`` is one request per input row, in row order. The
    physical relQuery's requests are a subset (dedup leaders), possibly
    reordered; leaders are the *same objects* as their logical counterparts,
    so per-row handles resolve directly for them, while followers (in
    ``fanout``) are materialized by copying the leader's stream when the
    physical relQuery completes (or is cancelled)."""

    rel_id: str
    logical: RelQuery              # per-row view the caller observes
    physical: Optional[RelQuery]   # what the Frontend actually schedules
    logical_requests: List[Request]
    fanout: FanoutMap = field(default_factory=dict)
    node: Optional[PlanNode] = None
    rows: Optional[List[dict]] = None   # source rows (un-projected), if any

    @property
    def num_logical(self) -> int:
        return len(self.logical_requests)

    @property
    def num_physical(self) -> int:
        return len(self.physical.requests) if self.physical is not None else 0

    @property
    def deduped_requests(self) -> int:
        """Logical requests answered by fan-out instead of execution."""
        return (self.num_logical - self.num_physical
                if self.physical is not None else 0)

    def request_for_row(self, row_idx: int) -> Request:
        return self.logical_requests[row_idx]


class Planner:
    """Rule-based workload planner. Stateless between calls except for the
    cumulative ``plan_time`` clock."""

    def __init__(self, mode: str = "full",
                 tokenizer: Optional[HashTokenizer] = None):
        if mode not in PLAN_MODES:
            raise ValueError(f"plan mode must be one of {PLAN_MODES} "
                             f"(got {mode!r})")
        self.mode = mode
        self.tokenizer = tokenizer or HashTokenizer()
        self.plan_time = 0.0

    @property
    def dedup(self) -> bool:
        return self.mode in ("dedup", "full")

    @property
    def reorder(self) -> bool:
        return self.mode in ("reorder", "full")

    # ------------------------------------------------------------- requests
    def plan_relquery(self, rq: RelQuery,
                      node: Optional[PlanNode] = None) -> PlannedQuery:
        """Compile one already-rendered relQuery (a trace entry, or a DAG
        stage whose rows just materialized) into a planned unit."""
        t0 = _time.perf_counter()
        requests = list(rq.requests)
        fanout: FanoutMap = {}
        leaders = requests
        if self.dedup:
            leaders, fanout = dedup_requests(requests)
        if self.reorder:
            leaders = reorder_requests(leaders)
        if len(leaders) == len(requests) and \
                all(a is b for a, b in zip(leaders, requests)):
            physical = rq                  # nothing changed: zero-copy
        else:
            physical = RelQuery(rel_id=rq.rel_id, requests=leaders,
                                arrival_time=rq.arrival_time,
                                max_output_tokens=rq.max_output_tokens,
                                template_id=rq.template_id)
        planned = PlannedQuery(rel_id=rq.rel_id, logical=rq,
                               physical=physical, logical_requests=requests,
                               fanout=fanout, node=node)
        self.plan_time += _time.perf_counter() - t0
        return planned

    def plan_trace(self, trace: Sequence[RelQuery]) -> List[PlannedQuery]:
        """Compile a flat arrival trace (the serve.py / benchmark path)."""
        return [self.plan_relquery(rq) for rq in trace]

    # ------------------------------------------------------------- plan nodes
    def compile_node(self, node: PlanNode, rows: Sequence[dict],
                     rel_id: Optional[str] = None,
                     arrival_time: Optional[float] = None) -> PlannedQuery:
        """Render ``node``'s template over ``rows`` and compile. Projection
        runs first so dedup keys ignore columns the template never reads."""
        t0 = _time.perf_counter()
        projected = project_rows(rows, node.template)
        prompts = [self.tokenizer.encode(node.template.render(row))
                   for row in projected]
        ol = node.max_output_tokens
        rq = make_relquery(rel_id or node.node_id, prompts,
                           node.arrival_time if arrival_time is None
                           else arrival_time,
                           ol, template_id=node.template.template_id,
                           eos_token=self.tokenizer.eos)
        self.plan_time += _time.perf_counter() - t0
        planned = self.plan_relquery(rq, node=node)
        planned.rows = list(rows)
        return planned

    # ------------------------------------------------------------- outputs
    def decode_output(self, r: Request) -> str:
        """Decode a finished request's stream into the text a downstream
        template binds (the EOS terminator, if any, is stripped)."""
        toks = list(r.output_tokens)
        if toks and r.eos_token is not None and toks[-1] == r.eos_token:
            toks = toks[:-1]
        return self.tokenizer.decode(toks)


def fan_out(planned: PlannedQuery, now: Optional[float] = None) -> int:
    """Materialize follower requests from their leaders after the physical
    relQuery reached a terminal state (finished *or* cancelled): copy the
    stream and terminal markers so every logical row resolves. Also mirrors
    the physical relQuery's terminal timestamps onto the logical view.
    Returns the number of follower requests materialized."""
    phys, logical = planned.physical, planned.logical
    copied = 0
    leaders = {r.req_id: r for r in phys.requests}
    for leader_id, followers in planned.fanout.items():
        leader = leaders[leader_id]
        for f in followers:
            f.output_tokens = list(leader.output_tokens)
            f.prefilled = leader.prefilled
            f.prefilled_tokens = leader.prefilled_tokens
            f.state = leader.state
            f.finish_time = leader.finish_time
            copied += 1
    if logical is not phys:
        logical.first_prefill_start = phys.first_prefill_start
        logical.last_prefill_end = phys.last_prefill_end
        logical.finish_time = phys.finish_time
        logical.cancel_time = phys.cancel_time
        logical.preemptions = phys.preemptions
        logical.note_phase_change()
    return copied
