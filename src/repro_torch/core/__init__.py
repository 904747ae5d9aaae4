"""Scheduling core: the unified Batch type, latency model, DPU priorities,
the Adaptive Batch Arranger and the schedulers that tie them together."""
from repro_torch.core.batch import Batch
from repro_torch.core.latency_model import BatchLatencyModel, a100_opt13b
from repro_torch.core.relquery import RelQuery, Request, RequestState

__all__ = ["Batch", "BatchLatencyModel", "a100_opt13b",
           "RelQuery", "Request", "RequestState"]
