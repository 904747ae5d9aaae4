"""Serving layer of the port: the open-loop ``Frontend`` (submit / stream /
cancel / snapshot) over a relQuery-affine ``Router`` and a ``Cluster`` of
steppable ``EngineCore`` replicas sharing one clock, the autoscaler, and the
factories for a simulated cluster and a real PyTorch engine."""
from repro_torch.serving.autoscaler import AutoscaleConfig, Autoscaler
from repro_torch.serving.cluster import Cluster, ClusterReport
from repro_torch.serving.factory import (build_real_engine,
                                         build_simulated_cluster)
from repro_torch.serving.frontend import (Frontend, RelQueryCancelledError,
                                          RelQueryHandle, RelQueryStatus)
from repro_torch.serving.router import (ROUTER_POLICIES, Router,
                                        route_relquery, template_fingerprint)

__all__ = ["AutoscaleConfig", "Autoscaler", "Cluster", "ClusterReport",
           "Frontend", "RelQueryCancelledError", "RelQueryHandle",
           "RelQueryStatus", "Router", "ROUTER_POLICIES", "build_real_engine",
           "build_simulated_cluster", "route_relquery",
           "template_fingerprint"]
