"""Plan execution over the open-loop ``Frontend``.

``PlanExecutor`` is the layer that turns planned units into live serving
traffic: it submits each stage's *physical* relQuery through
``Frontend.submit``, steps the engine, fans dedup leaders' streams out to
their follower rows on completion, and — for dependent-query DAGs —
materializes a downstream stage's rows from its upstreams' decoded outputs
the moment the last dependency completes, submitting it mid-flight (the
open-loop API is what makes this possible at all: dependent stages arrive
while earlier stages are still decoding).

Lifecycle guarantees:

* a dependent stage is **never** submitted before every upstream stage is
  terminal (its arrival time is the service time its last dependency
  finished at);
* cancellation propagates along DAG edges: cancelling a stage (explicitly,
  or via a deadline) cancels every transitive downstream stage — submitted
  ones through ``Frontend.cancel``, unsubmitted ones before they ever reach
  the engine;
* deadlines propagate: ``submit_plan(deadline=...)`` applies the same
  absolute service-time deadline to every stage, including stages submitted
  later by the DAG walk;
* reports stay honest about logical vs physical work: ``snapshot()`` /
  ``drain()`` return the engine's ``ServiceReport`` with
  ``deduped_requests`` (logical rows answered by fan-out, not execution)
  and ``plan_time`` (planner wall-clock) stamped on.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.relquery import RelQuery, RequestState
from repro_torch.engine.engine import ServiceReport
from repro_torch.planner.plan import PlanNode, QueryPlan
from repro_torch.planner.planner import Planner, PlannedQuery, fan_out
from repro_torch.serving.frontend import Frontend, RelQueryHandle, RelQueryStatus


class _LiveQuery:
    """Book-keeping for one planned unit in flight."""

    def __init__(self, planned: PlannedQuery):
        self.planned = planned
        self.handle: Optional[RelQueryHandle] = None
        self.settled = False        # terminal + fanned out

    @property
    def submitted(self) -> bool:
        return self.handle is not None


class PlanHandle:
    """Caller-facing handle for one submitted ``QueryPlan``: per-stage
    status, per-row partial outputs, whole-DAG cancel."""

    def __init__(self, executor: "PlanExecutor", plan: QueryPlan,
                 live: Dict[str, _LiveQuery]):
        self.executor = executor
        self.plan = plan
        self._live = live
        self.deadline: Optional[float] = None

    def stage(self, node_id: str) -> PlannedQuery:
        return self._live[node_id].planned

    def stage_handle(self, node_id: str) -> Optional[RelQueryHandle]:
        return self._live[node_id].handle

    def status(self, node_id: str) -> RelQueryStatus:
        lq = self._live[node_id]
        if lq.handle is not None:
            return lq.handle.status()
        if lq.planned.logical.cancelled:
            return RelQueryStatus.CANCELLED
        return RelQueryStatus.QUEUED       # awaiting upstream completion

    def done(self) -> bool:
        return all(self.status(nid) in (RelQueryStatus.FINISHED,
                                        RelQueryStatus.CANCELLED)
                   for nid in self._live)

    def partial_outputs(self, node_id: str) -> Dict[str, List[int]]:
        """Per-logical-row streams so far. Follower rows mirror their dedup
        leader live (fan-out copies lazily here, terminally in ``fan_out``)."""
        lq = self._live[node_id]
        phys = {r.req_id: list(r.output_tokens)
                for r in lq.planned.physical.requests}
        out = {}
        for r in lq.planned.logical_requests:
            if r.req_id in phys:
                out[r.req_id] = phys[r.req_id]
        for leader_id, followers in lq.planned.fanout.items():
            for f in followers:
                out[f.req_id] = list(phys[leader_id])
        return out

    def result(self, node_id: str) -> RelQuery:
        """Drive the whole plan until ``node_id`` is terminal; return its
        logical relQuery (every row resolved)."""
        lq = self._live[node_id]
        while not lq.settled:
            if not self.executor.step() and not lq.settled:
                raise RuntimeError(
                    f"plan stage {node_id!r} cannot finish: engine is idle "
                    f"and no dependency can unblock it")
        return lq.planned.logical

    def cancel(self, node_id: Optional[str] = None) -> List[str]:
        """Cancel a stage (default: every root → the whole plan) and all its
        transitive downstream stages. Returns the cancelled node ids."""
        if node_id is None:
            targets = list(self._live)
        else:
            targets = [node_id] + self.plan.downstream_of(node_id)
        cancelled = []
        for nid in targets:
            if self.executor._cancel_stage(self._live[nid]):
                cancelled.append(nid)
        return cancelled


class PlanExecutor:
    """Submits planned work through a ``Frontend`` and walks DAG edges."""

    def __init__(self, frontend: Frontend, planner: Optional[Planner] = None):
        self.frontend = frontend
        self.planner = planner or Planner("full")
        self._live: List[_LiveQuery] = []
        self._plans: List[PlanHandle] = []

    # ------------------------------------------------------------- flat traces
    def replay(self, planned: Sequence[PlannedQuery],
               max_iterations: int = 2_000_000) -> ServiceReport:
        """Closed-loop replay of a planned flat trace: submit each physical
        relQuery at its recorded arrival, interleaved with engine steps in
        global time order (the planner-aware twin of ``Frontend.replay``),
        fanning out dedup followers as stages finish. Returns the drained,
        planner-stamped report."""
        pending = sorted(planned, key=lambda p: p.physical.arrival_time)
        live = [_LiveQuery(p) for p in pending]
        self._live.extend(live)
        idx, it = 0, 0
        while True:
            f = self.frontend.next_step_time()
            next_step = math.inf if f is None else f
            next_arrival = (pending[idx].physical.arrival_time
                            if idx < len(pending) else math.inf)
            if math.isinf(next_step) and math.isinf(next_arrival):
                break
            if next_arrival <= next_step:
                live[idx].handle = self.frontend.submit(
                    pending[idx].physical, now=next_arrival)
                idx += 1
                continue
            self.frontend.step()
            self._poll()
            it += 1
            if it >= max_iterations:
                raise RuntimeError("planned replay exceeded max_iterations "
                                   "— likely livelock")
        self._poll()
        return self.snapshot()

    # ------------------------------------------------------------- DAG plans
    def submit_plan(self, plan: QueryPlan, now: Optional[float] = None,
                    deadline: Optional[float] = None) -> PlanHandle:
        """Compile and submit a DAG plan: root stages enter the engine now,
        dependent stages as their dependencies complete (via ``step``)."""
        live: Dict[str, _LiveQuery] = {}
        for node in plan.topological():
            if node.is_dependent:
                # compiled later, when upstream outputs exist; placeholder
                # carries the node so cancellation can reach it pre-submit
                planned = PlannedQuery(
                    rel_id=f"{plan.plan_id}/{node.node_id}",
                    logical=RelQuery(rel_id=f"{plan.plan_id}/{node.node_id}",
                                     requests=[], arrival_time=0.0,
                                     max_output_tokens=node.max_output_tokens,
                                     template_id=node.template.template_id),
                    physical=None, logical_requests=[], node=node)
                live[node.node_id] = _LiveQuery(planned)
            else:
                planned = self.planner.compile_node(
                    node, node.rows, rel_id=f"{plan.plan_id}/{node.node_id}",
                    arrival_time=now)
                lq = _LiveQuery(planned)
                lq.handle = self.frontend.submit(planned.physical, now=now,
                                                 deadline=deadline)
                live[node.node_id] = lq
        handle = PlanHandle(self, plan, live)
        handle.deadline = deadline
        self._plans.append(handle)
        self._live.extend(live.values())
        return handle

    def run_plan(self, plan: QueryPlan, now: Optional[float] = None,
                 deadline: Optional[float] = None,
                 max_iterations: int = 2_000_000) -> PlanHandle:
        """Submit and drive a plan to completion (every stage terminal)."""
        handle = self.submit_plan(plan, now=now, deadline=deadline)
        it = 0
        while not handle.done():
            if not self.step() and not handle.done():
                raise RuntimeError("plan cannot finish: engine is idle with "
                                   "unfinished stages")
            it += 1
            if it >= max_iterations:
                raise RuntimeError("run_plan exceeded max_iterations")
        return handle

    # ------------------------------------------------------------- stepping
    def step(self) -> bool:
        """One engine step + DAG/fan-out poll. Returns False when the engine
        was idle *and* the poll released no new work."""
        event = self.frontend.step()
        released = self._poll()
        return event is not None or released

    def _poll(self) -> bool:
        """Fan out newly terminal stages; submit dependent stages whose
        upstreams are all terminal. Returns True if anything was released."""
        progressed = False
        for lq in self._live:
            if lq.settled or lq.handle is None:
                continue
            if lq.handle.done():
                fan_out(lq.planned)
                lq.settled = True
                progressed = True
        for handle in self._plans:
            progressed |= self._release_dependents(handle)
        return progressed

    def _release_dependents(self, handle: PlanHandle) -> bool:
        released = False
        for node in handle.plan.dependents():
            lq = handle._live[node.node_id]
            if lq.submitted or lq.settled or lq.planned.logical.cancelled:
                continue
            ups = [handle._live[up] for up, _ in node.depends_on]
            if not all(u.settled for u in ups):
                continue
            if any(u.planned.logical.cancelled for u in ups):
                # upstream died (cancel or deadline): propagate, never submit
                self._cancel_stage(lq)
                released = True
                continue
            rows = self._dependent_rows(node, handle)
            now = self.frontend.now
            planned = self.planner.compile_node(
                node, rows, rel_id=lq.planned.rel_id, arrival_time=now)
            lq.planned = planned
            lq.handle = self.frontend.submit(planned.physical, now=now,
                                             deadline=handle.deadline)
            released = True
        return released

    def _dependent_rows(self, node: PlanNode,
                        handle: PlanHandle) -> List[dict]:
        """Join each upstream's per-row decoded outputs into the first
        upstream's rows (by row index — same table, new derived columns).
        The base rows are the upstream's *source* rows (un-projected: a
        downstream template may reference columns the upstream's own
        projection dropped)."""
        base: Optional[List[dict]] = None
        counts = {up_id: handle._live[up_id].planned.num_logical
                  for up_id, _ in node.depends_on}
        if len(set(counts.values())) > 1:
            raise ValueError(
                f"plan stage {node.node_id!r}: upstream row counts differ "
                f"({counts}) — dependent stages join by row index")
        for up_id, attr in node.depends_on:
            up = handle._live[up_id].planned
            up_rows = (up.rows if up.rows is not None
                       else [{} for _ in up.logical_requests])
            if base is None:
                base = [dict(row) for row in up_rows]
            for i, r in enumerate(up.logical_requests):
                base[i][attr] = self.planner.decode_output(r)
        return base or []

    # ------------------------------------------------------------- lifecycle
    def _cancel_stage(self, lq: _LiveQuery) -> bool:
        """Cancel one stage: through the Frontend when submitted, locally
        (before the engine ever saw it) otherwise. Fan-out still runs so
        follower rows mirror whatever the leaders produced before eviction."""
        planned = lq.planned
        if lq.handle is not None:
            was_live = lq.handle.cancel()
            if not lq.settled:
                fan_out(planned)
                lq.settled = True
            return was_live
        if planned.logical.cancelled:
            return False
        planned.logical.cancel_time = self.frontend.now
        for r in planned.logical_requests:
            r.state = RequestState.CANCELLED
        planned.logical.note_phase_change()
        lq.settled = True
        return True

    # ------------------------------------------------------------- reporting
    @property
    def deduped_requests(self) -> int:
        return sum(lq.planned.deduped_requests for lq in self._live
                   if lq.planned.physical is not None)

    def snapshot(self) -> ServiceReport:
        """The engine's consistent report with the planner's logical-vs-
        physical accounting stamped on."""
        rep = self.frontend.snapshot()
        rep.deduped_requests = self.deduped_requests
        rep.plan_time = self.planner.plan_time
        return rep

    def drain(self, max_iterations: int = 2_000_000) -> ServiceReport:
        it = 0
        while self.frontend.has_work() or self._poll():
            self.step()
            it += 1
            if it >= max_iterations:
                raise RuntimeError("drain exceeded max_iterations")
        self._poll()
        return self.snapshot()
