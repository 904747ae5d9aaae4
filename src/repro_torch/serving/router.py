"""Front-end request router across data-parallel engine replicas.

relQuery-affine hashing keeps every request of a relQuery on one replica —
that is what keeps per-replica prefix caching effective (requests of one
relQuery share the template prefix) and what makes relQuery latency a
single-replica quantity. The affine policy optionally *spills over* to the
least-loaded replica when the home replica is hot: a relQuery's requests still
travel together (the spill decision is made once, at admission), only the home
assignment moves.

``prefix_affinity`` widens the affinity unit from one relQuery to one
*template*: relQueries rendered from the same task template share a long
prompt prefix, so sending them to the same replica turns cross-relQuery
prefix-cache hits from a coincidence into a policy. The template fingerprint
(template_id, or the first prompt block when untagged) maps to a sticky home
replica chosen on first sight — preferring a replica whose cache is already
warm for this prompt prefix when the backend supplies a warmth signal, else
the least-loaded replica — with the same hot-home spillover as
``affinity_spill`` (a spilled relQuery keeps its template's home assignment:
one hot burst must not thrash the template map).

Policies:
- ``affinity``        — pure stable-hash placement, load-blind.
- ``affinity_spill``  — affine placement unless the home replica's load
  exceeds ``spill_factor`` x the least-loaded replica's (plus a small absolute
  slack); then the relQuery lands on the least-loaded replica. Default.
- ``prefix_affinity`` — template-affine placement with warmth-aware first
  assignment and least-loaded spillover.
- ``least_loaded``    — ignore affinity, always pick the least-loaded replica.
- ``round_robin``     — classic baseline, load- and affinity-blind.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Sequence

from repro_torch.core.relquery import RelQuery

ROUTER_POLICIES = ("affinity", "affinity_spill", "prefix_affinity",
                   "least_loaded", "round_robin")


def route_relquery(rel_id: str, num_replicas: int) -> int:
    """Stable relQuery-affine hash (deterministic across processes, unlike
    builtin ``hash`` which is seed-randomized)."""
    return zlib.crc32(rel_id.encode()) % max(1, num_replicas)


# canonical definition lives in core (the predictor keys on it too);
# re-exported here for the router's existing callers
from repro_torch.core.predictor import template_fingerprint  # noqa: F401,E402


class Router:
    def __init__(self, num_replicas: int, policy: str = "affinity_spill",
                 spill_factor: float = 2.0, spill_slack: int = 8):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {ROUTER_POLICIES}")
        self.num_replicas = num_replicas
        self.policy = policy
        self.spill_factor = spill_factor
        self.spill_slack = spill_slack
        self._rr = 0
        self._template_home: Dict[int, int] = {}   # fingerprint -> replica
        self.max_template_homes = 4096             # oldest dropped beyond this
        # ``template_homes`` is the LIVE map size (eviction and replica death
        # shrink it); ``template_homes_created`` counts first-sight
        # assignments cumulatively — the two diverge once the FIFO bound or
        # ``evict_replica`` fires.
        self.stats = {"routed": 0, "spilled": 0, "template_homes": 0,
                      "template_homes_created": 0, "warm_hits": 0,
                      "rehomed": 0}

    # ------------------------------------------------------------- elasticity
    def grow(self, num_replicas: int) -> None:
        """Widen the replica index space (the cluster added replicas)."""
        if num_replicas < self.num_replicas:
            raise ValueError(
                f"grow({num_replicas}) below current {self.num_replicas}; "
                f"shrinking routes through eligibility, not resizing")
        self.num_replicas = num_replicas

    def evict_replica(self, replica: int) -> int:
        """Forget template homes pinned to a dead/retired replica. Affected
        templates re-home on next sight (warmth/load-aware), exactly like a
        FIFO-evicted entry. Returns the number of homes dropped."""
        gone = [fp for fp, home in self._template_home.items()
                if home == replica]
        for fp in gone:
            del self._template_home[fp]
        self.stats["template_homes"] = len(self._template_home)
        return len(gone)

    # ---------------------------------------------------------------- routing
    def route(self, rq: RelQuery, loads: Optional[Sequence[int]] = None,
              warmth: Optional[Sequence[int]] = None,
              eligible: Optional[Sequence[int]] = None) -> int:
        """Pick the replica for ``rq``. ``loads`` is the per-replica
        outstanding-request count at admission time (required by the
        load-aware policies); ``warmth`` is an optional per-replica
        cached-prefix-token probe for ``rq``'s prompts (prefix_affinity);
        ``eligible`` restricts placement to the admitting replicas (draining
        and dead replicas drop out) — None means all are admitting."""
        self.stats["routed"] += 1
        elig = list(range(self.num_replicas)) if eligible is None \
            else sorted(eligible)
        if not elig:
            raise ValueError("route() needs at least one eligible replica")
        if len(elig) == 1:
            return elig[0]
        elig_set = set(elig)
        if self.policy == "round_robin":
            r = self._rr % self.num_replicas
            while r not in elig_set:
                r = (r + 1) % self.num_replicas
            self._rr = (r + 1) % self.num_replicas
            return r
        if self.policy == "prefix_affinity":
            home = self._template_home_for(rq, loads, warmth, elig)
        else:
            home = route_relquery(rq.rel_id, self.num_replicas)
            if home not in elig_set:
                # the affine home is not admitting: fall back to a stable
                # hash over the eligible set so placement stays deterministic
                home = elig[zlib.crc32(rq.rel_id.encode()) % len(elig)]
        if self.policy == "affinity" or loads is None:
            return home
        coldest = min(elig, key=lambda i: (loads[i], i))
        if self.policy == "least_loaded":
            return coldest
        # affinity_spill / prefix_affinity: stay home unless home is
        # disproportionately hot.
        if loads[home] > loads[coldest] * self.spill_factor + self.spill_slack:
            self.stats["spilled"] += 1
            return coldest
        return home

    def _template_home_for(self, rq: RelQuery, loads: Optional[Sequence[int]],
                           warmth: Optional[Sequence[int]],
                           elig: Sequence[int]) -> int:
        """Sticky template->replica assignment. First sight of a template
        picks the warmest replica (its cache already holds this prefix), else
        the least-loaded one, else the stable hash; later relQueries follow."""
        fp = template_fingerprint(rq)
        home = self._template_home.get(fp)
        elig_set = set(elig)
        if home is not None and home in elig_set:
            # sticky homes can go stale in a long-running service: if the
            # home's cache no longer holds this prefix but another replica's
            # does (e.g. past spillover traffic warmed it), follow the warmth
            if warmth is not None and warmth[home] == 0 \
                    and max(warmth[i] for i in elig) > 0:
                home = max(elig, key=lambda i: (warmth[i], -i))
                self._template_home[fp] = home
                self.stats["rehomed"] += 1
            return home
        if home is not None:
            # the sticky home stopped admitting (drain/crash): rehome below
            self.stats["rehomed"] += 1
        if warmth is not None and max(warmth[i] for i in elig) > 0:
            home = max(elig, key=lambda i: (warmth[i], -i))
            self.stats["warm_hits"] += 1
        elif loads is not None:
            home = min(elig, key=lambda i: (loads[i], i))
        else:
            home = elig[fp % len(elig)]
        if fp not in self._template_home:
            self.stats["template_homes_created"] += 1
        self._template_home[fp] = home
        while len(self._template_home) > self.max_template_homes:
            # FIFO bound (insertion-ordered dict): an evicted template simply
            # re-homes on next sight — the map must not grow without bound
            self._template_home.pop(next(iter(self._template_home)))
        self.stats["template_homes"] = len(self._template_home)
        return home
