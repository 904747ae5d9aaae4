"""The traced sub-window of a ``--trace 1`` run.

``torch.profiler`` over the window's last few seconds: the
device's kernels, copies and sets from CUPTI, and the host spans the harness
marks around its calls into the program (``span``: ``relbench.<name>``,
which name the idle gaps). ``read`` reduces the trace to what the per-layer
metrics and the result's ``device`` and ``breakdown`` keys need: device
seconds by kernel name, the seconds in which anything ran on the device
(the union of the activities' intervals), the sub-window's length, and the
idle gaps summed by the host span in which they fall.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "relbench."


def span(name: str):
    """A host span the trace keeps (a no-op when no profiler runs)."""
    return record_function(PREFIX + name)


def warm(device) -> None:
    """Start and stop the profiler once, in set-up: the first start pays
    for CUPTI's initialisation."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class TraceWindow:
    """Profile ``length`` seconds from ``start`` (seconds on the run's
    clock, polled between the harness's ticks). The length counts from the
    moment the profiler has started, which can take seconds."""

    def __init__(self, start: float, length: float, device):
        self.start, self.length = start, length
        self.end = float("inf")
        self.device = device
        self.prof: Optional[profile] = None
        self.t0 = self.t1 = None          # host perf_counter at start, stop
        self.start_s = self.stop_s = 0.0  # seconds it took to start, stop

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def poll(self, now: float) -> None:
        if self.prof is None and now >= self.start:
            before = time.perf_counter()
            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
            self.start_s = self.t0 - before
            self.end = now + self.start_s + self.length
        elif self.active and now >= self.end:
            self.stop()

    def stop(self) -> None:
        if self.active:
            torch.cuda.synchronize(self.device)
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.stop_s = time.perf_counter() - self.t1

    def read(self) -> Optional[dict]:
        """None if the window never opened."""
        if self.prof is None:
            return None
        self.stop()
        dev: List[Tuple[int, int, str]] = []
        spans: List[Tuple[int, int, str]] = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            d = e.duration_ns()
            if e.name().startswith(PREFIX):
                if e.device_type() != cuda:
                    spans.append((e.start_ns(), e.start_ns() + d,
                                  e.name()[len(PREFIX):]))
            elif e.device_type() == cuda and not e.is_user_annotation():
                # kernels, copies, sets (not the host spans' shadows on the
                # device's timeline)
                if d > 0:
                    dev.append((e.start_ns(), e.start_ns() + d, e.name()))
        window_s = self.t1 - self.t0
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in dev:
            by_name[name] += (e - s) * 1e-9
        busy_ns, gaps = 0, []
        dev.sort()
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_ns += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_ns += cur_e - cur_s
        return {"window_s": window_s, "busy_s": busy_ns * 1e-9,
                "kernels": dict(by_name), "idle_gaps": _label(gaps, spans)}


def _label(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost host span that holds each gap's
    middle ("loop" where none does). The spans nest (one host thread), so
    one sweep with a stack of open spans finds it."""
    spans = sorted(spans)
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for s, e in sorted(gaps):
        mid = (s + e) // 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "loop"] += (e - s) * 1e-9
    return dict(out)

