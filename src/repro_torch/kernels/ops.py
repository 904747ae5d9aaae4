"""Device dispatch for the kernels, and their launch counters.

A CUDA tensor goes to the hand-written CUDA kernel (or the wrapper raises);
a CPU tensor goes to the plain version in ``ref``, which is what the CPU
tests run. Each launch of a CUDA kernel adds one to its counter; the plain
path counts nothing, so the counters show which path a run took. A CUDA
graph replays launches without calling the wrappers: its capture records
what the wrappers counted (``uncounted``) and each replay adds that
(``add_launches``; ``engine/graphs.py``).

The kernels are forward-only, as the reference's Pallas kernels have no VJP:
a wrapper given a tensor that requires grad raises rather than return a
result that autograd cannot see through. Training runs the models' plain
paths (``train_loss``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk_cuda

_launches: Dict[str, int] = {name: 0 for name in build.KERNELS}


def _forward_only(name: str, *tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (no backward): an input requires grad; "
            f"train through the model's plain path")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    *, num_q_tokens: int = 1):
    """See ``paged_attention.py`` for layouts."""
    _forward_only("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       context_lens, num_q_tokens=num_q_tokens)
    out = paged_attention_cuda(q, k_pages, v_pages, block_tables,
                               context_lens, num_q_tokens=num_q_tokens)
    _launches["paged_attention"] += 1
    return out


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """See ``flash_prefill.py`` for layouts."""
    _forward_only("flash_prefill", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    out = flash_prefill_cuda(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    _launches["flash_prefill"] += 1
    return out


def rwkv6_chunk(r, k, v, logw, u, state, *, out_dtype=None, chunk=None):
    """See ``rwkv6_chunk.py`` for layouts; ``chunk`` None is one chunk of
    S tokens. Returns (o, state after the last chunk)."""
    _forward_only("rwkv6_chunk", r, k, v, logw, u, state)
    if r.device.type == "cpu":
        return ref.rwkv6_chunk_plain(r, k, v, logw, u, state,
                                     out_dtype=out_dtype, chunk=chunk)
    out = rwkv6_chunk_cuda(r, k, v, logw, u, state, out_dtype=out_dtype,
                           chunk=chunk)
    _launches["rwkv6_chunk"] += 1
    return out


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


@contextlib.contextmanager
def uncounted() -> Iterator[Dict[str, int]]:
    """Launches counted inside the block are taken out of the counters again
    when it ends, and left in the dict it yields, by kernel: a graph's
    capture and its warm-up serve no step."""
    before = dict(_launches)
    seen: Dict[str, int] = {}
    try:
        yield seen
    finally:
        for name in _launches:
            seen[name] = _launches[name] - before[name]
            _launches[name] = before[name]


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    for name, n in counts.items():
        _launches[name] += n
