"""What the per-layer metrics' readers share: a run's window rows and
batches, and the counts of ``flops.py`` over them. Each reader in
``metrics/`` returns None where its run has nothing to read."""
from __future__ import annotations

import math
from typing import Optional, Sequence

from relbench import flops


def percentile(values: Sequence[float], q: float) -> float:
    """Linear interpolation between order statistics (q in [0, 1])."""
    v = sorted(values)
    x = q * (len(v) - 1)
    lo = int(math.floor(x))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def window_rows(run) -> list:
    return [r for r in run.rows.values() if r.window]


def percent(x: float) -> float:
    return 100.0 * x


def step_mfu(run) -> Optional[float]:
    """Model operations of the window's batches over the peak times the
    sum of their walls, in %."""
    batches = run.window_batches()
    wall = sum(b.end - b.start for b in batches)
    if not batches or wall <= 0:
        return None
    work = sum(flops.prefill_flops(run.dims, b.prefill_lens)
               + flops.decode_flops(run.dims, b.decode_ctx) for b in batches)
    return percent(work / (flops.PEAK_FLOPS * wall))


def kernel_seconds(run, name: str) -> float:
    """Device seconds of the traced kernels whose name holds ``name``."""
    return sum(s for k, s in run.trace["kernels"].items() if name in k)


def roofline(run, kernel: str) -> Optional[float]:
    """The traced calls' least time (``flops.bound_s`` of each batch's
    call, for every layer) over the kernel's device time, in %."""
    if run.trace is None:
        return None
    spent = kernel_seconds(run, kernel)
    call = {"flash_prefill": lambda b: flops.flash_prefill_call(run.dims, b.prefill_lens),
            "paged_attention": lambda b: flops.paged_attention_call(run.dims, b.decode_ctx)}[kernel]
    lens = {"flash_prefill": lambda b: b.prefill_lens,
            "paged_attention": lambda b: b.decode_ctx}[kernel]
    bound = sum(flops.bound_s(call(b)) * run.dims["L"]
                for b in run.traced_batches() if lens(b))
    if spent <= 0 or bound <= 0:
        return None
    return percent(bound / spent)


def idle(run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return percent(1.0 - run.trace["busy_s"] / run.trace["window_s"])


def prefix_hit(run) -> Optional[float]:
    if run.prefix_lookups <= 0:
        return None
    return percent(run.prefix_hits / run.prefix_lookups)
