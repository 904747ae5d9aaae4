"""Kernels: the least time of the traced paged_attention calls (flops.py, real contexts) over the kernel's device time (torch.profiler), in %."""
from relbench.readers import roofline


def read(run):
    return roofline(run, "paged_attention")
