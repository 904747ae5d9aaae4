"""Relational query planner: workload-level optimization in front of the
scheduler.

The layer between the data layer (tables / templates / traces) and
``Frontend.submit``: a ``QueryPlan`` DAG IR over (table, template) inputs, a
rule-based ``Planner`` (exact-duplicate dedup with answer fan-out, column
projection, prefix-maximizing row reorder) and a ``PlanExecutor`` that walks
dependent-query DAGs through the open-loop serving API.
"""
from repro_torch.planner.executor import PlanExecutor, PlanHandle
from repro_torch.planner.passes import (dedup_requests, project_rows,
                                  reorder_requests, request_identity)
from repro_torch.planner.plan import PlanNode, QueryPlan, derive, scan
from repro_torch.planner.planner import (PLAN_MODES, PlannedQuery, Planner, fan_out)

__all__ = ["PLAN_MODES", "PlanExecutor", "PlanHandle", "PlanNode",
           "PlannedQuery", "Planner", "QueryPlan", "dedup_requests", "derive",
           "fan_out", "project_rows", "reorder_requests", "request_identity",
           "scan"]
