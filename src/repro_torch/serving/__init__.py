"""Serving layer of the port: the open-loop ``Frontend`` and the real-engine
factory. The router, cluster and autoscaler are not ported yet."""
from repro_torch.serving.factory import build_real_engine
from repro_torch.serving.frontend import (Frontend, RelQueryCancelledError,
                                          RelQueryHandle, RelQueryStatus)

__all__ = ["Frontend", "RelQueryCancelledError", "RelQueryHandle",
           "RelQueryStatus", "build_real_engine"]
