"""``Cluster``: elastic data-parallel ``EngineCore`` replicas on one simulated
clock, with crash-recovery.

The cluster is an *open-loop* backend: ``submit(rq, now)`` routes a relQuery
to an admitting replica the moment it arrives (using the replicas' queue
depths at that moment plus an in-flight-batch indicator — load state is
one-batch granular because a tick retires its batch atomically) and ``step()``
advances the earliest busy replica by one batch (each replica executes its
batches serially; replicas run in parallel with each other). ``repro_torch.serving.
Frontend`` drives these two calls for interactive submit/stream/cancel
serving; ``run_trace`` is the closed-loop compatibility shim that replays a
prebuilt arrival trace through the same loop.

Elasticity (Ray Serve mold, on the simulated clock so every scenario is
deterministic):

- ``add_replica(now)`` spawns a fresh scheduler+executor stack from the
  construction-time factories and widens the router.
- ``drain_replica(i, now)`` stops admitting on ``i``, migrates its quiescent
  (no resident KV) relQueries to surviving replicas via the snapshot codec,
  lets resident work finish, then retires the replica and freezes its report.
- ``crash_replica(i, now)`` kills ``i`` outright: its KV and post-snapshot
  progress are gone. In-flight relQueries fail over to surviving replicas —
  rewound to the last periodic snapshot (``snapshot_every``) when one exists,
  from scratch otherwise. The deterministic executor regenerates the lost
  tokens bit-identically and the Frontend's per-request high-water marks
  suppress re-emission, so final client streams match a crash-free run.
- ``metrics_snapshot(now)`` is the live observability surface (per-replica
  queue depth, KV device/host occupancy, preemptions, swaps, prefix-hit
  ratio, router spills) consumed by benchmarks and ``serve.py
  --metrics-log``; an attached ``Autoscaler`` reads the same signals.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.relquery import RelQuery, Request
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.engine.engine import (BatchEvent, EngineCore, ServiceReport,
                                 merge_reports)
from repro_torch.serving.router import Router

REPLICA_UP = "up"
REPLICA_DRAINING = "draining"
REPLICA_DEAD = "dead"


@dataclass
class ClusterReport:
    merged: ServiceReport
    per_replica: List[ServiceReport]
    assignments: dict = field(default_factory=dict)   # rel_id -> replica
    router_stats: dict = field(default_factory=dict)
    replica_states: List[str] = field(default_factory=list)
    scale_events: List[dict] = field(default_factory=list)
    crash_events: List[dict] = field(default_factory=list)

    @property
    def num_replicas(self) -> int:
        return len(self.per_replica)


class Cluster:
    """Drives an elastic fleet of independent scheduler+executor stacks. The
    factories are kept for the fleet's lifetime and called once per replica —
    ``make_scheduler(i)`` strictly before ``make_executor(i)`` (factories may
    share per-replica state such as a prefix cache) — so replicas never share
    mutable state, and ``add_replica`` can mint identical fresh stacks."""

    def __init__(self, make_scheduler: Callable[[int], object],
                 make_executor: Callable[[int], object],
                 num_replicas: int, router: Optional[Router] = None,
                 engine_loop: str = "serial", debug_invariants: bool = False,
                 snapshot_every: int = 0):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")
        self._make_scheduler = make_scheduler
        self._make_executor = make_executor
        self._engine_loop = engine_loop
        self._debug_invariants = debug_invariants
        self.snapshot_every = snapshot_every
        self.cores: List[EngineCore] = []
        self.clocks: List[float] = []           # replica-local frontier
        self.replica_state: List[str] = []
        self._ticks: List[int] = []             # per-replica batches retired
        self._replica_snaps: Dict[int, dict] = {}   # last periodic snapshot
        self._frozen_reports: Dict[int, ServiceReport] = {}
        # late-core observers (the Frontend registers its on_batch listener
        # installer here so replicas added after construction stream too)
        self.core_added_hooks: List[Callable[[EngineCore], None]] = []
        self.scale_events: List[dict] = []
        self.crash_events: List[dict] = []
        self.autoscaler = None
        for _ in range(num_replicas):
            self._spawn(0.0)
        self.router = router or Router(num_replicas)
        if self.router.num_replicas != num_replicas:
            raise ValueError("router sized for a different replica count")
        self.assignments: dict = {}

    # ------------------------------------------------------------- elasticity
    def _spawn(self, clock: float) -> int:
        i = len(self.cores)
        sched = self._make_scheduler(i)
        executor = self._make_executor(i)
        core = EngineCore(sched, executor, replica_id=i,
                          engine_loop=self._engine_loop,
                          debug_invariants=self._debug_invariants)
        self.cores.append(core)
        self.clocks.append(clock)
        self.replica_state.append(REPLICA_UP)
        self._ticks.append(0)
        for hook in self.core_added_hooks:
            hook(core)
        return i

    def admitting_replicas(self) -> List[int]:
        return [i for i, s in enumerate(self.replica_state) if s == REPLICA_UP]

    def add_replica(self, now: float) -> int:
        """Scale up: spawn a fresh replica whose clock starts at ``now``."""
        i = self._spawn(now)
        self.router.grow(len(self.cores))
        self.scale_events.append({"time": now, "action": "add", "replica": i})
        return i

    def drain_replica(self, i: int, now: float) -> dict:
        """Graceful scale-down: stop admitting on ``i``, migrate its
        quiescent relQueries (waiting/preempted, no resident KV — nothing to
        lose) to surviving replicas through the snapshot codec, and let
        resident work finish. The replica retires lazily from ``step()`` the
        moment it runs dry."""
        if self.replica_state[i] != REPLICA_UP:
            raise ValueError(f"replica {i} is {self.replica_state[i]}, "
                             f"not up")
        if len(self.admitting_replicas()) <= 1:
            raise ValueError("cannot drain the last admitting replica")
        self.replica_state[i] = REPLICA_DRAINING
        core = self.cores[i]
        core._flush_plan()   # materialize any speculative window first
        sched = core.scheduler
        movable: List[RelQuery] = []
        for rq in list(sched.relqueries.values()):
            if rq.finish_time is not None or rq.cancel_time is not None:
                continue
            if all(r.is_terminal() or
                   (r.state.value in ("waiting", "preempted")
                    and not r.prefilled_tokens) for r in rq.requests):
                movable.append(rq)
        migrated = 0
        for rq in movable:
            snap_rq = ft.snapshot_relquery(sched, rq)
            sched.remove_relquery(rq.rel_id)
            ft.rewind_relquery_to_snapshot(rq, snap_rq)
            self.submit(rq, now)
            migrated += 1
        event = {"time": now, "action": "drain", "replica": i,
                 "migrated": migrated}
        self.scale_events.append(event)
        if not core.has_work():
            self._retire(i, now)
        return event

    def _retire(self, i: int, now: float) -> None:
        self._frozen_reports[i] = self.cores[i].report(self.clocks[i])
        self.replica_state[i] = REPLICA_DEAD
        self.router.evict_replica(i)
        self.scale_events.append(
            {"time": now, "action": "retire", "replica": i})

    # ---------------------------------------------------------- fault injection
    def snapshot_replica(self, i: int,
                         delivered: Optional[Dict[str, int]] = None) -> dict:
        """Checkpoint replica ``i``'s full scheduler state (crash-recovery
        anchor). Periodic snapshots run from ``step()`` every
        ``snapshot_every`` batches."""
        core = self.cores[i]
        core._flush_plan()
        snap = ft.snapshot_scheduler(core.scheduler, delivered=delivered)
        self._replica_snaps[i] = snap
        return snap

    def crash_replica(self, i: int, now: float) -> dict:
        """Deterministic replica-crash injection at simulated time ``now``:
        replica ``i``'s device/host KV and all post-snapshot progress are
        lost. Unfinished relQueries fail over to surviving replicas — rewound
        to the last periodic snapshot when one exists, restarted from scratch
        otherwise — and the router forgets template homes pinned to ``i``.
        Work the replica had already finished is durable (its report freezes
        with the crash). Returns the crash event record."""
        if self.replica_state[i] == REPLICA_DEAD:
            raise ValueError(f"replica {i} is already dead")
        survivors = [j for j in self.admitting_replicas() if j != i]
        if not survivors:
            raise ValueError("cannot crash the last admitting replica")
        core = self.cores[i]
        core._flush_plan()
        sched = core.scheduler
        snap = self._replica_snaps.pop(i, None)
        snap_rqs = {q["rel_id"]: q for q in snap["relqueries"]} if snap else {}
        victims = [rq for rq in sched.relqueries.values()
                   if rq.finish_time is None and rq.cancel_time is None]
        # the crashed replica takes its unfinished work with it: detach the
        # victims before freezing its report, or merge_reports would let the
        # frozen (stale) entries shadow the surviving replicas' live ones
        for rq in victims:
            del sched.relqueries[rq.rel_id]
        self._frozen_reports[i] = core.report(self.clocks[i])
        self.replica_state[i] = REPLICA_DEAD
        self.router.evict_replica(i)
        kept = lost = from_snap = 0
        for rq in sorted(victims, key=lambda q: (q.arrival_time, q.rel_id)):
            q = snap_rqs.get(rq.rel_id)
            if q is not None:
                kept += ft.rewind_relquery_to_snapshot(rq, q)
                from_snap += 1
            else:
                lost += ft.reset_relquery_for_recovery(rq)
            self.submit(rq, now)
        event = {"time": now, "replica": i, "victims": len(victims),
                 "from_snapshot": from_snap, "tokens_preserved": kept,
                 "tokens_lost": lost}
        self.crash_events.append(event)
        return event

    # ------------------------------------------------------------- autoscaling
    def attach_autoscaler(self, autoscaler) -> "Cluster":
        """Install an ``Autoscaler`` (ticked from ``submit`` and ``step``)."""
        self.autoscaler = autoscaler
        return self

    # ------------------------------------------------------------- open loop
    def submit(self, rq: RelQuery, now: float) -> int:
        """Route ``rq`` at service time ``now`` and admit it to an admitting
        replica. Returns the replica index. Queue depth plus an in-flight
        indicator: a tick retires its batch at the batch's *start* ordering,
        so a replica whose frontier is past ``now`` was still busy at it —
        without the indicator, load-aware routing reads post-completion
        state and dumps work on a replica that is hours from free."""
        if self.autoscaler is not None:
            self.autoscaler.tick(now)
        admitting = self.admitting_replicas()
        if not admitting:
            raise RuntimeError("no admitting replicas (all draining or dead)")
        loads = [c.load() + (1 if self.clocks[i] > now else 0)
                 if self.replica_state[i] != REPLICA_DEAD else 0
                 for i, c in enumerate(self.cores)]
        warmth = self._cache_warmth(rq) \
            if self.router.policy == "prefix_affinity" else None
        replica = self.router.route(rq, loads, warmth=warmth,
                                    eligible=admitting)
        self.assignments[rq.rel_id] = replica
        core = self.cores[replica]
        if not core.has_work():   # replica idled until this arrival
            self.clocks[replica] = max(self.clocks[replica], now)
        core.admit(rq, now)
        return replica

    def _cache_warmth(self, rq: RelQuery) -> Optional[List[int]]:
        """Per-replica cached-token probe for ``rq``'s template prefix: how
        much of the first request's prompt each replica's prefix cache
        already holds. Side-effect free (``peek_cached``) — the probe must
        not perturb LRU order or hit statistics."""
        if not rq.requests:
            return None
        tokens = rq.requests[0].tokens
        warmth = []
        for core in self.cores:
            pc = getattr(core.scheduler, "prefix_cache", None)
            peek = getattr(pc, "peek_cached", None)
            warmth.append(peek(tokens) if peek is not None else 0)
        return warmth

    def step(self) -> Optional[BatchEvent]:
        """Tick the earliest busy live replica (one batch). None when all
        idle; raises ``EngineDeadlockError`` on a truly stuck replica."""
        for i, state in enumerate(self.replica_state):
            if state == REPLICA_DRAINING and not self.cores[i].has_work():
                self._retire(i, self.clocks[i])
        busy = [i for i, c in enumerate(self.cores)
                if self.replica_state[i] != REPLICA_DEAD and c.has_work()]
        if not busy:
            return None
        i = min(busy, key=lambda j: self.clocks[j])
        event = self.cores[i].tick(self.clocks[i])
        if event is not None:
            self.clocks[i] = event.end
            self._ticks[i] += 1
            if self.snapshot_every \
                    and self._ticks[i] % self.snapshot_every == 0 \
                    and self.replica_state[i] == REPLICA_UP:
                self.snapshot_replica(i)
            if self.autoscaler is not None:
                self.autoscaler.tick(event.end)
        return event

    def has_work(self) -> bool:
        return any(c.has_work() for i, c in enumerate(self.cores)
                   if self.replica_state[i] != REPLICA_DEAD)

    def frontier(self) -> Optional[float]:
        """Start time of the next batch across the fleet; None when idle."""
        busy = [self.clocks[i] for i, c in enumerate(self.cores)
                if self.replica_state[i] != REPLICA_DEAD and c.has_work()]
        return min(busy) if busy else None

    def end_time(self) -> float:
        live = [self.clocks[i] for i in range(len(self.cores))
                if self.replica_state[i] != REPLICA_DEAD]
        return max(live) if live else max(self.clocks)

    def cancel_relquery(self, rel_id: str, now: float) -> List[Request]:
        """Cancel on whichever replica the relQuery was routed to."""
        replica = self.assignments.get(rel_id)
        if replica is None or self.replica_state[replica] == REPLICA_DEAD:
            return []
        return self.cores[replica].cancel_relquery(rel_id, now)

    # ----------------------------------------------------------- observability
    def metrics_snapshot(self, now: Optional[float] = None) -> dict:
        """One live metrics sample across the fleet — the stream
        ``serve.py --metrics-log`` writes and the autoscaler/benchmarks read.
        Pure observation: no scheduler state is touched."""
        replicas = []
        for i, core in enumerate(self.cores):
            state = self.replica_state[i]
            if state == REPLICA_DEAD:
                replicas.append({"replica": i, "state": state})
                continue
            s = core.scheduler
            pc = getattr(s, "prefix_cache", None)
            entry = {
                "replica": i,
                "state": state,
                "clock": self.clocks[i],
                "queue_depth": s.queue_depth(),
                "running": len(s._running),
                "swapped": len(s._swapped),
                "kv_tokens_in_use": s.tokens_in_use,
                "kv_partial_prefill_tokens": s.partial_prefill_tokens,
                "kv_committed_tokens": s.committed_tokens,
                "kv_host_tokens_in_use": getattr(s, "host_tokens_in_use", 0),
                "preemptions": getattr(s, "preemptions", 0),
                "swap_outs": getattr(s, "swap_outs", 0),
                "swap_ins": getattr(s, "swap_ins", 0),
            }
            if pc is not None and hasattr(pc, "hit_ratio"):
                entry["prefix_hit_ratio"] = pc.hit_ratio
            replicas.append(entry)
        return {
            "time": self.end_time() if now is None else now,
            "replicas": replicas,
            "num_replicas": len(self.cores),
            "admitting": len(self.admitting_replicas()),
            "router": dict(self.router.stats),
            "assignments": len(self.assignments),
            "scale_events": len(self.scale_events),
            "crash_events": len(self.crash_events),
        }

    def reports(self) -> List[ServiceReport]:
        # core.report flushes any pipelined speculative window first, so a
        # mid-flight snapshot never observes projected (placeholder) state;
        # dead replicas contribute the report frozen at crash/retire time
        return [self._frozen_reports[i]
                if self.replica_state[i] == REPLICA_DEAD
                else core.report(self.clocks[i])
                for i, core in enumerate(self.cores)]

    def report(self) -> ClusterReport:
        reports = self.reports()
        return ClusterReport(merged=merge_reports(reports),
                             per_replica=reports,
                             assignments=dict(self.assignments),
                             router_stats=dict(self.router.stats),
                             replica_states=list(self.replica_state),
                             scale_events=list(self.scale_events),
                             crash_events=list(self.crash_events))

    # ------------------------------------------------------------------
    def run_trace(self, trace: Sequence[RelQuery],
                  max_iterations: int = 2_000_000) -> ClusterReport:
        """Replay a full arrival trace across the fleet.

        .. deprecated:: closed-loop compatibility shim. Drive the open-loop
           ``repro_torch.serving.Frontend`` over this cluster instead; this method
           is now a thin trace-replay driver over it and produces the
           identical merged ``ClusterReport``.
        """
        from repro_torch.serving.frontend import Frontend

        fe = Frontend(self)
        try:
            fe.replay(trace, max_iterations=max_iterations)
        finally:
            fe.close()
        return self.report()
