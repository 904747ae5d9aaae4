"""Device dispatch for the attention kernels, and their launch counters.

A CUDA tensor goes to the hand-written CUDA kernel (or the wrapper raises);
a CPU tensor goes to the plain version in ``ref``, which is what the CPU
tests run. Each launch of a CUDA kernel adds one to its counter; the plain
path counts nothing, so the counters show which path a run took.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda

_launches: Dict[str, int] = {name: 0 for name in build.KERNELS}


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    *, num_q_tokens: int = 1):
    """See ``paged_attention.py`` for layouts."""
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
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    out = flash_prefill_cuda(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    _launches["flash_prefill"] += 1
    return out


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
