"""Kernels: the least time of the traced flash_prefill calls (flops.py, real lengths) over the kernel's device time (torch.profiler), in %."""
from relbench.readers import roofline


def read(run):
    return roofline(run, "flash_prefill")
