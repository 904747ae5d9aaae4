"""One CUDA graph per shape bucket of the real executors' steps (the paged
executor's copy-on-write among them), and of the captured train step and
cells: the port's counterpart of the reference's ``_aot``
(``repro/engine/executor.py:128-138``), which lowers and compiles a step
once per bucket and then runs the executable, and of its jitted train step
and compiled cells.

``capture(fn, init, device, pool=..., stream=...)`` returns a ``Step`` and
the seconds it took. ``fn`` takes device tensors of the shapes and dtypes of
the host arrays ``init`` (tokens, positions, lengths, block tables; a train
batch's frames beside its tokens) and returns ``(outputs, state)``:
``outputs`` a tensor or a tuple of tensors (logits; a train step's loss and
grad norm), ``state`` what ``fn`` updated in place (KV pools, a dense cache,
parameters and optimizer state) or wrote fresh (a prefill's cache). With a
``pool`` (CUDA) the step runs ``fn`` once on ``init`` (the warm-up, a real
run: lazy initialisation happens outside the capture), then captures it
into a ``torch.cuda.CUDAGraph`` on ``stream``, its memory taken from the
private ``pool`` (every graph of one executor shares one). Without a pool
(the CPU, or eager steps on CUDA when the caller asked for them) the step
calls ``fn`` at every call.

A call copies its host arrays into the step's static input buffer with one
host-to-device copy (through pinned memory on CUDA; ``Step.load``), then
replays the graph or calls ``fn`` (``Step.run``). A replay returns the graph's static outputs cloned: two
replays of one bucket in a batch (two dense prefills of one length) would
otherwise leave both requests the second one's logits.

Everything a captured launch reads stays where it was at capture: the
parameters, the pools or cache, the optimizer state, the static inputs,
and the buffers the kernels' wrappers allocate inside the capture (from the
graph's pool). The kernels' TMA tensor maps, encoded on the host at
capture, point there.

Launch counts: a capture and its warm-up run the kernels' wrappers without
serving a step, so their counts are taken out again (``ops.uncounted``);
each replay adds the counts its capture saw (``ops.add_launches``).

The graphs of one pool are replayed in any order, one at a time on one
stream: a graph's intermediates may reuse memory another graph's capture
freed, never its static outputs, which live as long as their step.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


ALIGN = 16      # bytes: each static input starts on this boundary


class Step:
    """One shape bucket's step over static inputs of the shapes and dtypes
    ``specs`` (see the module docstring), held in one byte buffer.
    ``calls`` counts the steps served; ``graph`` is None for an eager
    step."""

    def __init__(self, fn: Callable,
                 specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 device: torch.device):
        self.fn = fn
        self.device = device
        self.spans = []
        off = 0
        for shape, dtype in specs:
            n = int(np.prod(shape)) * dtype.itemsize
            self.spans.append((off, n, tuple(shape), dtype))
            off += -(-n // ALIGN) * ALIGN
        self.buf = torch.zeros(off, dtype=torch.uint8, device=device)
        self.inputs = [self._view(self.buf, span) for span in self.spans]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self.calls = 0
        self.capture_s = 0.0      # the capture's seconds, the warm-up not counted

    @staticmethod
    def _view(buf: torch.Tensor, span) -> torch.Tensor:
        o, n, shape, dtype = span
        return buf[o:o + n].view(dtype).view(shape)

    def load(self, arrays: Sequence) -> None:
        """Copy one host array (numpy or a CPU tensor) per input into the
        static buffer, cast to the input's dtype."""
        on_cuda = self.device.type == "cuda"
        host = torch.empty(self.buf.numel(), dtype=torch.uint8,
                           pin_memory=on_cuda)
        for span, a in zip(self.spans, arrays):
            a = torch.as_tensor(a)
            if tuple(a.shape) != span[2]:
                raise ValueError(f"input of shape {tuple(a.shape)}, the "
                                 f"step's is {span[2]}")
            self._view(host, span).copy_(a)
        self.buf.copy_(host, non_blocking=on_cuda)

    def capture(self, pool, stream: torch.cuda.Stream, *,
                release: bool = False):
        """Warm up on ``stream``, then capture ``fn`` into a graph whose
        memory comes from ``pool``; returns the warm-up's outputs, cloned.
        With ``release`` the allocator's cache is emptied between the two,
        so that the warm-up's transient memory is not held beside the
        pool's copy of it (a train step's). Raises if the capture fails."""
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with ops.uncounted(), torch.cuda.stream(stream):
            warm = self.fn(*self.inputs)[0]
        current.wait_stream(stream)
        warm = _cloned(warm)
        if release:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        # torch.cuda.graph would synchronize the device and empty the caching
        # allocator first: a capture in the middle of a serve needs neither
        # (the capture stream has waited for the compute stream above)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a graph that the cyclic
        # collector destroys there (a dropped step's) invalidates it
        # (torch.cuda.graph collects before it captures instead)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with ops.uncounted() as seen, torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    outputs = self.fn(*self.inputs)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.outputs, self.launches = graph, outputs, seen
        self.capture_s = time.perf_counter() - t0
        return warm

    def __call__(self, *arrays):
        self.load(arrays)
        return self.run()

    def run(self):
        """Serve one step on the inputs ``load`` left: replay the graph (or
        call ``fn``)."""
        self.calls += 1
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        ops.add_launches(self.launches)
        out, *rest = self.outputs
        return (_cloned(out), *rest)


def _cloned(out):
    """A step's outputs (a tensor or a tuple of them), cloned."""
    if isinstance(out, tuple):
        return tuple(x.clone() for x in out)
    return out.clone()


def specs_of(arrays: Sequence) -> list:
    """(shape, torch dtype) of each host array (numpy or a CPU tensor)."""
    return [(tuple(t.shape), t.dtype) for t in map(torch.as_tensor, arrays)]


def capture(fn: Callable, init: Sequence, device: torch.device, *,
            pool=None, stream: Optional[torch.cuda.Stream] = None
            ) -> Tuple[Step, float]:
    """The step of one bucket, over inputs of the shapes and dtypes of the
    host arrays ``init``, and the seconds it took: captured into ``pool``
    on ``stream`` from ``init``, or eager without a ``pool``."""
    t0 = time.perf_counter()
    step = Step(fn, specs_of(init), device)
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
