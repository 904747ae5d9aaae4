"""Query-plan IR: a DAG of templated relQuery stages over tables.

The data layer builds *flat* relQueries (one rendered request per table row);
this IR sits one level above it, describing the workload **before** any
request is rendered, so the planner can rewrite it:

* ``PlanNode`` — one templated LLM call over a row set. A *root* node carries
  its rows (a ``Table`` slice or raw row dicts); a *dependent* node carries
  none — its rows are materialized at execution time by joining each upstream
  node's per-row decoded outputs into the upstream rows (AugServe-style
  multi-stage requests: a stage-2 prompt rendered from stage-1 answers).
* ``QueryPlan`` — a validated DAG of nodes (unique ids, acyclic, dependents
  reference existing upstreams), iterable in topological order.

The planner's passes (`repro_torch.planner.passes`) rewrite the *compiled* request
lists; the executor (`repro_torch.planner.executor`) walks the DAG through the
open-loop ``Frontend``, submitting each stage as its dependencies complete.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.data.tables import Table
from repro_torch.data.templates import RelQueryTemplate

# Attribute name an upstream node's decoded output binds to in downstream
# rows when the edge does not name one explicitly.
DEFAULT_OUTPUT_ATTR = "answer"


@dataclass
class PlanNode:
    """One templated relQuery stage.

    ``depends_on`` is a list of ``(upstream_node_id, bind_attr)`` edges: the
    node's rows are the first upstream's rows, each extended with every
    upstream's decoded per-row output under its ``bind_attr``. All upstreams
    of one node must produce the same number of rows (they are joined by row
    index — the relational reading: same table, new derived columns).
    """

    node_id: str
    template: RelQueryTemplate
    rows: Optional[List[Dict[str, str]]] = None
    depends_on: List[Tuple[str, str]] = field(default_factory=list)
    arrival_time: float = 0.0
    output_token_cap: Optional[int] = None

    @property
    def is_dependent(self) -> bool:
        return bool(self.depends_on)

    @property
    def max_output_tokens(self) -> int:
        ol = self.template.max_output_tokens
        if self.output_token_cap is not None:
            ol = max(1, min(ol, self.output_token_cap))
        return ol


def scan(node_id: str, source: Union[Table, Sequence[Dict[str, str]]],
         template: RelQueryTemplate, arrival_time: float = 0.0,
         output_token_cap: Optional[int] = None) -> PlanNode:
    """Root node: render ``template`` over every row of ``source``."""
    rows = list(source.rows) if isinstance(source, Table) else list(source)
    if not rows:
        raise ValueError(f"plan node {node_id!r}: empty row set")
    return PlanNode(node_id, template, rows=rows, arrival_time=arrival_time,
                    output_token_cap=output_token_cap)


def derive(node_id: str,
           upstream: Union[str, PlanNode,
                           Sequence[Union[str, PlanNode, Tuple[str, str]]]],
           template: RelQueryTemplate,
           output_token_cap: Optional[int] = None) -> PlanNode:
    """Dependent node: render ``template`` over the upstream rows extended
    with the upstream outputs. ``upstream`` is a node (or its id), or a list
    of nodes / ids / ``(node_id, bind_attr)`` pairs for multi-parent joins."""
    if isinstance(upstream, (str, PlanNode)):
        upstream = [upstream]
    edges: List[Tuple[str, str]] = []
    for up in upstream:
        if isinstance(up, PlanNode):
            edges.append((up.node_id, DEFAULT_OUTPUT_ATTR))
        elif isinstance(up, str):
            edges.append((up, DEFAULT_OUTPUT_ATTR))
        else:
            edges.append((up[0], up[1]))
    if not edges:
        raise ValueError(f"plan node {node_id!r}: dependent node needs at "
                         f"least one upstream")
    attrs = [a for _, a in edges]
    if len(set(attrs)) != len(attrs):
        raise ValueError(f"plan node {node_id!r}: duplicate bind attr in "
                         f"{attrs}")
    return PlanNode(node_id, template, rows=None, depends_on=edges,
                    output_token_cap=output_token_cap)


class QueryPlan:
    """A validated DAG of ``PlanNode``s, iterable in topological order."""

    def __init__(self, nodes: Sequence[PlanNode], plan_id: str = "plan"):
        self.plan_id = plan_id
        self.nodes: Dict[str, PlanNode] = {}
        for node in nodes:
            if node.node_id in self.nodes:
                raise ValueError(f"duplicate plan node id {node.node_id!r}")
            self.nodes[node.node_id] = node
        for node in nodes:
            if node.is_dependent and node.rows is not None:
                raise ValueError(f"plan node {node.node_id!r}: dependent "
                                 f"nodes render their rows from upstream "
                                 f"outputs, not a static row set")
            if not node.is_dependent and node.rows is None:
                raise ValueError(f"plan node {node.node_id!r}: root node "
                                 f"without rows")
            for up, _ in node.depends_on:
                if up not in self.nodes:
                    raise ValueError(f"plan node {node.node_id!r} depends on "
                                     f"unknown node {up!r}")
        self._topo = self._toposort()

    def _toposort(self) -> List[str]:
        order: List[str] = []
        state: Dict[str, int] = {}   # 0=unvisited 1=visiting 2=done

        def visit(nid: str, chain: Tuple[str, ...]) -> None:
            if state.get(nid) == 2:
                return
            if state.get(nid) == 1:
                raise ValueError(f"query plan has a cycle through {nid!r} "
                                 f"(path {' -> '.join(chain + (nid,))})")
            state[nid] = 1
            for up, _ in self.nodes[nid].depends_on:
                visit(up, chain + (nid,))
            state[nid] = 2
            order.append(nid)

        for nid in self.nodes:
            visit(nid, ())
        return order

    def topological(self) -> List[PlanNode]:
        return [self.nodes[nid] for nid in self._topo]

    def roots(self) -> List[PlanNode]:
        return [n for n in self.topological() if not n.is_dependent]

    def dependents(self) -> List[PlanNode]:
        return [n for n in self.topological() if n.is_dependent]

    def downstream_of(self, node_id: str) -> List[str]:
        """Transitive closure of nodes depending on ``node_id`` — the set a
        cancellation must propagate to."""
        out, frontier = set(), {node_id}
        while frontier:
            nxt = {n.node_id for n in self.nodes.values()
                   if any(up in frontier for up, _ in n.depends_on)}
            nxt -= out
            out |= nxt
            frontier = nxt
        return [nid for nid in self._topo if nid in out]

    def __len__(self) -> int:
        return len(self.nodes)
