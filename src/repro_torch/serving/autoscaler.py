"""Queue-depth and latency-SLO autoscaler for the elastic ``Cluster``.

Ray-Serve-style control loop on the simulated clock: every
``eval_interval_s`` of simulated time it reads two signals from the fleet —
mean queue depth per admitting replica and the windowed p50 relQuery latency
— and scales between ``min_replicas`` and ``max_replicas``:

- scale UP (``cluster.add_replica``) when queue depth per replica exceeds
  ``scale_up_queue``, or the p50 breaches ``p50_slo_s`` (when configured);
- scale DOWN when queue depth per replica falls below ``scale_down_queue``
  and the SLO is healthy — by *gracefully draining* the least-loaded
  admitting replica (``cluster.drain_replica``): it stops admitting, its
  quiescent relQueries migrate via the snapshot codec, resident work
  finishes, then it retires.

One action per evaluation, separated by ``cooldown_s``, so a single burst
cannot thrash the fleet. Every action is recorded in ``decisions`` with the
signals that triggered it. The cluster ticks the autoscaler from ``submit``
and ``step``, so no separate driver loop is needed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_queue: float = 8.0    # outstanding requests per admitting replica
    scale_down_queue: float = 1.0
    p50_slo_s: Optional[float] = None   # None: queue-depth signal only
    latency_window_s: float = 120.0     # p50 lookback over finished relQueries
    eval_interval_s: float = 1.0
    cooldown_s: float = 10.0

    def validate(self) -> "AutoscaleConfig":
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.eval_interval_s <= 0:
            raise ValueError("eval_interval_s must be > 0")
        if self.scale_down_queue > self.scale_up_queue:
            raise ValueError("scale_down_queue must not exceed scale_up_queue")
        return self


class Autoscaler:
    def __init__(self, cluster, config: Optional[AutoscaleConfig] = None):
        self.cluster = cluster
        self.cfg = (config or AutoscaleConfig()).validate()
        self._last_eval = float("-inf")
        self._last_action = float("-inf")
        self.decisions: List[dict] = []

    # ----------------------------------------------------------------- signals
    def signals(self, now: float) -> dict:
        admitting = self.cluster.admitting_replicas()
        depth = sum(self.cluster.cores[i].load() for i in admitting)
        per_replica = depth / max(1, len(admitting))
        cutoff = now - self.cfg.latency_window_s
        lats = []
        for i, core in enumerate(self.cluster.cores):
            if self.cluster.replica_state[i] == "dead":
                continue   # frozen history; its finished work predates the window
            for rq in core.scheduler.finished_relqueries:
                if rq.cancel_time is None and rq.finish_time is not None \
                        and rq.finish_time >= cutoff:
                    lats.append(rq.finish_time - rq.arrival_time)
        lats.sort()
        p50 = lats[len(lats) // 2] if lats else None
        return {"admitting": len(admitting),
                "queue_per_replica": per_replica,
                "p50_latency_s": p50,
                "window_finished": len(lats)}

    # -------------------------------------------------------------------- tick
    def tick(self, now: float) -> Optional[dict]:
        """Evaluate and possibly act. Reentrancy-safe: the eval-interval
        stamp is taken first, so actions that re-enter ``cluster.submit``
        (drain migration) see an already-evaluated tick and return."""
        if now - self._last_eval < self.cfg.eval_interval_s:
            return None
        self._last_eval = now
        if now - self._last_action < self.cfg.cooldown_s:
            return None
        sig = self.signals(now)
        n = sig["admitting"]
        slo_breach = (self.cfg.p50_slo_s is not None
                      and sig["p50_latency_s"] is not None
                      and sig["p50_latency_s"] > self.cfg.p50_slo_s)
        if n < self.cfg.max_replicas and \
                (sig["queue_per_replica"] > self.cfg.scale_up_queue
                 or slo_breach):
            replica = self.cluster.add_replica(now)
            decision = {"time": now, "action": "scale_up", "replica": replica,
                        "reason": "p50_slo" if slo_breach else "queue_depth",
                        "signals": sig}
            self._last_action = now
            self.decisions.append(decision)
            return decision
        if n > self.cfg.min_replicas and not slo_breach and \
                sig["queue_per_replica"] < self.cfg.scale_down_queue:
            admitting = self.cluster.admitting_replicas()
            # drain the least-loaded admitting replica; ties prefer the
            # youngest so the original fleet stays intact longest
            victim = min(admitting,
                         key=lambda i: (self.cluster.cores[i].load(), -i))
            decision = {"time": now, "action": "scale_down",
                        "replica": victim, "reason": "queue_depth",
                        "signals": sig}
            self._last_action = now
            self.decisions.append(decision)
            self.cluster.drain_replica(victim, now)
            return decision
        return None
