"""Open-loop serving frontend: the public submission surface of the system.

``Frontend`` turns the steppable ``EngineCore``/``Cluster`` stack into a
session-oriented serving API: callers *submit* relQueries while the engine is
running, *stream* tokens as they are generated, *cancel* mid-flight work (or
attach a deadline), and take consistent mid-flight ``snapshot()`` reports —
the request-lifecycle shape online serving systems (FastServe, vLLM's
AsyncLLMEngine) expose, rather than closed-loop trace replay.

The frontend owns the clock: on the simulated executor the clock is simulated
time advanced batch-by-batch, on the real JAX executor the same loop advances
over measured wall durations — identical code path either way. Trace replay is
now just one driver of this API (``replay``), and the legacy
``ServingEngine.run_trace`` / ``Cluster.run_trace`` entry points are thin
shims over it that reproduce their historical reports exactly.

Lifecycle of one relQuery::

    submit(rq) ─► QUEUED ──first prefill──► RUNNING ──last request──► FINISHED
                     │                        │ ▲  ╲
                     │       on_token(req_id, tok)  ╲ handle.cancel() /
                     │                        │ │    ╲ deadline exceeded
                     │                 KV pressure re-prefill
                     │                 (requests PREEMPTED,     ╲
                     │                  generation preserved)    ╲
                     └───────────────────────────────► CANCELLED
                                       (queue + KV commitment reclaimed)

Under ``kv_admission="optimistic"`` individual requests of a RUNNING relQuery
may be preempted (KV reclaimed, restart by re-prefill of prompt + generation
so far) — the handle stays RUNNING throughout; ``handle.preemptions`` counts
the cycles and ``snapshot().preemptions`` aggregates them fleet-wide.
"""
from __future__ import annotations

import enum
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.relquery import RelQuery
from repro_torch.engine.engine import (BatchEvent, EngineCore, ServiceReport,
                                 ServingEngine, merge_reports)

TokenCallback = Callable[[str, int], None]   # (req_id, token)


class RelQueryStatus(enum.Enum):
    QUEUED = "queued"          # submitted, no prefill started yet
    RUNNING = "running"        # at least one request prefilling/decoding
    FINISHED = "finished"      # every request finished; latency is final
    CANCELLED = "cancelled"    # terminal: evicted, excluded from stats


TERMINAL_STATUSES = (RelQueryStatus.FINISHED, RelQueryStatus.CANCELLED)


class RelQueryCancelledError(RuntimeError):
    """Raised by ``RelQueryHandle.result()`` when the relQuery was cancelled."""


class RelQueryHandle:
    """Caller-facing handle for one submitted relQuery."""

    def __init__(self, frontend: "Frontend", rq: RelQuery, replica: int,
                 deadline: Optional[float] = None,
                 on_token: Optional[TokenCallback] = None):
        self.frontend = frontend
        self.rq = rq
        self.replica = replica
        self.deadline = deadline
        self._on_token = on_token
        self._delivered: Dict[str, int] = {r.req_id: 0 for r in rq.requests}

    @property
    def rel_id(self) -> str:
        return self.rq.rel_id

    def status(self) -> RelQueryStatus:
        if self.rq.cancelled:
            return RelQueryStatus.CANCELLED
        if self.rq.finish_time is not None:
            return RelQueryStatus.FINISHED
        if self.rq.first_prefill_start is not None:
            return RelQueryStatus.RUNNING
        return RelQueryStatus.QUEUED

    def done(self) -> bool:
        return self.status() in TERMINAL_STATUSES

    def partial_outputs(self) -> Dict[str, List[int]]:
        """Per-request generated tokens so far (generation order), at any
        point of the lifecycle — including after cancellation. Preemption
        never rolls these back: preserved tokens survive the restart."""
        return {r.req_id: list(r.output_tokens) for r in self.rq.requests}

    @property
    def preemptions(self) -> int:
        """Preempt→restart cycles this relQuery's requests went through under
        KV pressure (0 under conservative admission)."""
        return self.rq.preemptions

    def latency(self) -> Optional[float]:
        return self.rq.latency()

    def result(self, max_iterations: int = 2_000_000) -> RelQuery:
        """Drive the engine until this relQuery is terminal; return the
        relQuery (outputs live on its requests). Raises
        ``RelQueryCancelledError`` if it was cancelled first."""
        it = 0
        while not self.done():
            if self.frontend.step() is None and not self.done():
                raise RuntimeError(
                    f"relQuery {self.rel_id!r} cannot finish: engine is idle")
            it += 1
            if it >= max_iterations:
                raise RuntimeError("result() exceeded max_iterations — likely livelock")
        if self.status() is RelQueryStatus.CANCELLED:
            raise RelQueryCancelledError(
                f"relQuery {self.rel_id!r} was cancelled at t={self.rq.cancel_time}")
        return self.rq

    def cancel(self) -> bool:
        """Cancel this relQuery; True if it was live. Safe on terminal handles."""
        return self.frontend.cancel(self)

    # ------------------------------------------------------------- internal
    def _deliver_new_tokens(self) -> None:
        """Stream the not-yet-delivered suffix of every request's outputs —
        exactly the tokens the scheduler appended, in generation order."""
        if self._on_token is None:
            return
        for r in self.rq.requests:
            sent = self._delivered[r.req_id]
            toks = r.output_tokens
            while sent < len(toks):
                self._on_token(r.req_id, toks[sent])
                sent += 1
            self._delivered[r.req_id] = sent


class _SingleCoreBackend:
    """Adapts one ``EngineCore`` to the backend protocol ``Cluster`` natively
    implements (submit / step / frontier / end_time / cancel / reports)."""

    def __init__(self, core: EngineCore):
        self.cores = [core]
        self.clocks = [0.0]

    def submit(self, rq: RelQuery, now: float) -> int:
        core = self.cores[0]
        if not core.has_work():          # replica idled until this arrival
            self.clocks[0] = max(self.clocks[0], now)
        core.admit(rq, now)
        return 0

    def step(self) -> Optional[BatchEvent]:
        core = self.cores[0]
        if not core.has_work():
            return None
        event = core.tick(self.clocks[0])   # raises on true deadlock
        if event is not None:
            self.clocks[0] = event.end
        return event

    def has_work(self) -> bool:
        return self.cores[0].has_work()

    def frontier(self) -> Optional[float]:
        return self.clocks[0] if self.cores[0].has_work() else None

    def end_time(self) -> float:
        return self.clocks[0]

    def cancel_relquery(self, rel_id: str, now: float):
        return self.cores[0].cancel_relquery(rel_id, now)

    def reports(self) -> List[ServiceReport]:
        return [self.cores[0].report(self.clocks[0])]


def _make_backend(target):
    if isinstance(target, ServingEngine):
        target = target.core
    if isinstance(target, EngineCore):
        return _SingleCoreBackend(target)
    required = ("submit", "step", "has_work", "frontier", "end_time",
                "cancel_relquery", "reports", "cores")
    missing = [m for m in required if not hasattr(target, m)]
    if missing:
        raise TypeError(f"{type(target).__name__} does not implement the "
                        f"frontend backend protocol (missing {missing})")
    return target


class Frontend:
    """Session-oriented open-loop API over an ``EngineCore``, ``ServingEngine``
    or ``Cluster``. One frontend owns one backend's clock; interleave
    ``submit`` and ``step`` freely (a real async server would run the step
    loop on a task and feed submissions from network handlers)."""

    def __init__(self, backend: Union[EngineCore, ServingEngine, "object"]):
        self.backend = _make_backend(backend)
        self.handles: Dict[str, RelQueryHandle] = {}
        self._deadline_handles: List[RelQueryHandle] = []
        self._closed = False
        # Chain onto (don't clobber) any already-installed batch listener, so
        # a second Frontend over the same backend — e.g. the deprecated
        # run_trace shims — never detaches a live frontend's streaming.
        self._prev_on_batch = []
        self._installed = []
        for core in self.backend.cores:
            self._install_listener(core)
        # Elastic backends (Cluster) mint replicas after construction; the
        # hook keeps new cores streaming through this frontend too.
        hooks = getattr(self.backend, "core_added_hooks", None)
        if hooks is not None:
            hooks.append(self._install_listener)

    def _install_listener(self, core) -> None:
        prev = core.on_batch
        listener = self._chained(prev)
        core.on_batch = listener
        self._prev_on_batch.append(prev)
        self._installed.append(listener)

    def _chained(self, prev):
        def listener(event, batch, result):
            if prev is not None:
                prev(event, batch, result)
            self._on_batch(event, batch, result)
        return listener

    def close(self) -> None:
        """Deactivate this frontend's streaming and detach its batch
        listeners where possible, restoring whatever was installed before
        (idempotent). When frontends are closed out of stacking order the
        listener may still sit inside a newer frontend's chain — the
        ``_closed`` flag makes it inert there regardless. The deprecated
        run_trace shims call this so their throwaway frontends don't outlive
        the replay."""
        self._closed = True
        hooks = getattr(self.backend, "core_added_hooks", None)
        if hooks is not None and self._install_listener in hooks:
            hooks.remove(self._install_listener)
        for core, prev, mine in zip(self.backend.cores, self._prev_on_batch,
                                    self._installed):
            if core.on_batch is mine:
                core.on_batch = prev

    # ------------------------------------------------------------- clock views
    @property
    def now(self) -> float:
        """Current service time: the next batch-start frontier while busy,
        else the time everything already settled at."""
        f = self.backend.frontier()
        return self.backend.end_time() if f is None else f

    @property
    def clock(self) -> float:
        """The settled clock: max per-replica frontier (report end time)."""
        return self.backend.end_time()

    @property
    def cores(self) -> Sequence[EngineCore]:
        return self.backend.cores

    def has_work(self) -> bool:
        return self.backend.has_work()

    def next_step_time(self) -> Optional[float]:
        """Simulated start time of the next tick, or None when idle."""
        return self.backend.frontier()

    # ------------------------------------------------------------- lifecycle
    def submit(self, rq: RelQuery, *, deadline: Optional[float] = None,
               on_token: Optional[TokenCallback] = None,
               now: Optional[float] = None) -> RelQueryHandle:
        """Submit a relQuery at service time ``now`` (default: the current
        frontier — "arrives now"). ``deadline`` is an absolute service time
        after which the relQuery is auto-cancelled (checked at batch
        boundaries); ``on_token`` streams (req_id, token) in generation
        order. Returns the lifecycle handle."""
        if rq.rel_id in self.handles:
            raise ValueError(f"relQuery {rq.rel_id!r} already submitted")
        if now is None:
            # Interactive submission: the relQuery arrives "now", and latency
            # is measured from here. Trace replay passes the recorded arrival
            # explicitly instead, leaving the (shareable) trace untouched.
            now = self.now
            rq.arrival_time = now
        replica = self.backend.submit(rq, now)
        handle = RelQueryHandle(self, rq, replica, deadline=deadline,
                                on_token=on_token)
        self.handles[rq.rel_id] = handle
        if deadline is not None:
            self._deadline_handles.append(handle)
        return handle

    def attach(self, rq: RelQuery, *, replica: int = 0,
               on_token: Optional[TokenCallback] = None,
               delivered: Optional[Dict[str, int]] = None) -> RelQueryHandle:
        """Adopt a relQuery that is *already admitted* in the backend — the
        restart path: a replica restored via ``restore_scheduler`` comes up
        holding relQueries this (new) frontend never saw. ``delivered`` seeds
        the per-request streamed-token high-water marks (the restore result's
        ``delivered`` map), so re-prefilled generation is recomputed but
        never re-emitted to the client. Tokens already on the requests are
        treated as delivered when no floor is given."""
        if rq.rel_id in self.handles:
            raise ValueError(f"relQuery {rq.rel_id!r} already has a handle")
        handle = RelQueryHandle(self, rq, replica, on_token=on_token)
        floors = delivered or {}
        for r in rq.requests:
            handle._delivered[r.req_id] = floors.get(
                r.req_id, len(r.output_tokens))
        self.handles[rq.rel_id] = handle
        return handle

    def step(self) -> Optional[BatchEvent]:
        """Advance the backend by one batch (the earliest busy replica).
        Returns the executed ``BatchEvent``, or None when idle. Deadline
        cancellations are applied before the batch is scheduled."""
        t = self.backend.frontier()
        if t is None:
            return None
        self._expire_deadlines(t)
        return self.backend.step()

    def cancel(self, handle_or_rel_id: Union[RelQueryHandle, str],
               now: Optional[float] = None) -> bool:
        """Cancel a live relQuery: evict its waiting/running requests, reclaim
        their KV commitment and executor slots, and mark the handle terminal.
        Returns False (no-op) for finished/cancelled/unknown relQueries."""
        if isinstance(handle_or_rel_id, RelQueryHandle):
            handle = handle_or_rel_id
        else:
            h = self.handles.get(handle_or_rel_id)
            if h is None:
                return False
            handle = h
        if handle.done():
            return False
        t = self.now if now is None else now
        self.backend.cancel_relquery(handle.rel_id, t)
        return True

    def drain(self, max_iterations: int = 2_000_000) -> ServiceReport:
        """Run the engine until every submitted relQuery is terminal; return
        the final merged report."""
        it = 0
        while self.backend.has_work():
            self.step()
            it += 1
            if it >= max_iterations:
                raise RuntimeError("drain exceeded max_iterations — likely livelock")
        return self.snapshot()

    def snapshot(self) -> ServiceReport:
        """Consistent service report at the current clock — safe mid-flight:
        finished relQueries carry final latencies, unfinished ones simply have
        no latency entry yet, cancelled ones are listed separately. On the
        pipelined engine loop this (like ``cancel`` and ``submit``) flushes
        any speculative window first, so the view is always the exact serial
        state."""
        return merge_reports(self.backend.reports())

    # ------------------------------------------------------------- drivers
    def replay(self, trace: Sequence[RelQuery],
               max_iterations: int = 2_000_000, *,
               on_token: Optional[TokenCallback] = None) -> "Frontend":
        """Closed-loop trace replay expressed as an open-loop driver: submit
        each relQuery at its recorded arrival time, interleaved with engine
        steps in global time order. This is byte-for-byte the scheduling
        sequence of the legacy ``run_trace`` loops (the compatibility shims
        call this)."""
        pending = sorted(trace, key=lambda r: r.arrival_time)
        idx = 0
        it = 0
        while True:
            f = self.backend.frontier()
            next_step = math.inf if f is None else f
            next_arrival = (pending[idx].arrival_time if idx < len(pending)
                            else math.inf)
            if math.isinf(next_step) and math.isinf(next_arrival):
                break
            if next_arrival <= next_step:
                self.submit(pending[idx], now=next_arrival, on_token=on_token)
                idx += 1
                continue
            self.step()
            it += 1
            if it >= max_iterations:
                raise RuntimeError(
                    "serving loop exceeded max_iterations — likely livelock")
        return self

    # ------------------------------------------------------------- internal
    def _expire_deadlines(self, t: float) -> None:
        if not self._deadline_handles:
            return
        live = []
        for h in self._deadline_handles:
            if h.done():
                continue
            if h.deadline <= t:
                self.cancel(h, now=h.deadline)
            else:
                live.append(h)
        self._deadline_handles = live

    def _on_batch(self, event: BatchEvent, batch, result) -> None:
        if self._closed:
            return
        for rel_id in event.rel_ids:
            handle = self.handles.get(rel_id)
            if handle is not None:
                handle._deliver_new_tokens()
