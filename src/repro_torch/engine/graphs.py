"""One CUDA graph per shape bucket of the real executors' steps: the port's
counterpart of the reference's ``_aot`` (``repro/engine/executor.py:128-138``),
which lowers and compiles a step once per bucket and then runs the
executable.

``capture(fn, shapes, init, device, pool=..., stream=...)`` returns a
``Step`` and the seconds it took. ``fn`` takes int32 device tensors of
``shapes`` (tokens, positions, lengths, block tables) and returns
``(logits, state)``: ``state`` is what ``fn`` updated in place (KV pools, a
dense cache) or wrote fresh (a prefill's cache). With a ``pool`` (CUDA) the
step runs ``fn`` once on ``init`` (the warm-up: lazy initialisation happens
outside the capture), then captures it into a ``torch.cuda.CUDAGraph`` on
``stream``, its memory taken from the private ``pool`` that every graph of
one executor shares. Without a pool (the CPU, or eager steps on CUDA when
the caller asked for them) the step calls ``fn`` at every call.

A call copies its host arrays into the step's static input buffer with one
host-to-device copy (through pinned memory on CUDA), then replays the graph
or calls ``fn``. A replay returns the graph's static outputs, the logits
cloned: two replays of one bucket in a batch (two dense prefills of one
length) would otherwise leave both requests the second one's logits.

Everything a captured launch reads stays where it was at capture: the
parameters, the pools or cache, the static inputs, and the buffers the
kernels' wrappers allocate inside the capture (from the graph's pool). The
kernels' TMA tensor maps, encoded on the host at capture, point there.

Launch counts: a capture and its warm-up run the kernels' wrappers without
serving a step, so their counts are taken out again (``ops.uncounted``);
each replay adds the counts its capture saw (``ops.add_launches``).

The graphs of one pool are replayed in any order, one at a time on one
stream: a graph's intermediates may reuse memory another graph's capture
freed, never its static outputs, which live as long as their step.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


class Step:
    """One shape bucket's step over static int32 inputs (see the module
    docstring). ``calls`` counts the steps served; ``graph`` is None for an
    eager step."""

    def __init__(self, fn: Callable, shapes: Sequence[Tuple[int, ...]],
                 device: torch.device):
        self.fn = fn
        self.device = device
        self.spans = []
        off = 0
        for shape in shapes:
            n = int(np.prod(shape))
            self.spans.append((off, n, tuple(shape)))
            off += n
        self.buf = torch.zeros(off, dtype=torch.int32, device=device)
        self.inputs = [self.buf[o:o + n].view(shape)
                       for o, n, shape in self.spans]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self.calls = 0

    def load(self, arrays: Sequence[np.ndarray]) -> None:
        """Copy one host array per input into the static buffer."""
        on_cuda = self.device.type == "cuda"
        host = torch.empty(self.buf.numel(), dtype=torch.int32,
                           pin_memory=on_cuda)
        h = host.numpy()
        for (o, n, shape), a in zip(self.spans, arrays):
            a = np.asarray(a)
            if a.shape != shape:
                raise ValueError(f"input of shape {a.shape}, the step's is {shape}")
            h[o:o + n] = a.reshape(-1)
        self.buf.copy_(host, non_blocking=on_cuda)

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        """Warm up on ``stream``, then capture ``fn`` into a graph whose
        memory comes from ``pool``. Raises if the capture fails."""
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with ops.uncounted(), torch.cuda.stream(stream):
            self.fn(*self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        # torch.cuda.graph would synchronize the device and empty the caching
        # allocator first: a capture in the middle of a serve needs neither
        # (the capture stream has waited for the compute stream above)
        graph = torch.cuda.CUDAGraph()
        with ops.uncounted() as seen, torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                outputs = self.fn(*self.inputs)
            finally:
                graph.capture_end()
        self.graph, self.outputs, self.launches = graph, outputs, seen

    def __call__(self, *arrays: np.ndarray):
        self.load(arrays)
        self.calls += 1
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        ops.add_launches(self.launches)
        logits, *rest = self.outputs
        return (logits.clone(), *rest)


def capture(fn: Callable, shapes: Sequence[Tuple[int, ...]],
            init: Sequence[np.ndarray], device: torch.device, *,
            pool=None, stream: Optional[torch.cuda.Stream] = None
            ) -> Tuple[Step, float]:
    """The step of one bucket and the seconds it took: captured into
    ``pool`` on ``stream`` from the inputs ``init``, or eager without a
    ``pool``."""
    t0 = time.perf_counter()
    step = Step(fn, shapes, device)
    step.load(init)
    if pool is not None:
        step.capture(pool, stream)
    return step, time.perf_counter() - t0


def pool_bytes(pool) -> Optional[int]:
    """Device bytes of the segments that private pool ``pool`` holds
    (``torch.cuda.memory_snapshot``); None where the snapshot does not say
    which pool a segment belongs to."""
    total, known = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        known = True
        if tuple(pid) == tuple(pool):
            total += seg["total_size"]
    return total if known else None
