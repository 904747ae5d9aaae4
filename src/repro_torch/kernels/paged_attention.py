"""Paged-attention decode kernel: the Python side of
``csrc/paged_attention.cu`` (CUDA C++ for sm_90a), which replaces the Pallas
kernel ``repro/kernels/paged_attention.py``.

Layouts (the engine's packed-GQA scheme):
  q            [B, KV, Qt*Qp, hd]  Qt query tokens per sequence
  k/v_pages    [P, page, KV, hd]   paged KV pool of one layer
  block_tables [B, max_pages]      int32 page ids per sequence
  context_lens [B]                 int32 valid tokens per sequence

Block table entries must be valid page ids below ``P`` for every page the
context covers; the kernel reads them on the device without a bounds check.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_ROWS = 32          # Qt * Qp rows per (sequence, kv slot)

_launch = None


def _launcher():
    global _launch
    if _launch is None:
        fn = build.load("paged_attention").paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def paged_attention_cuda(q, k_pages, v_pages, block_tables, context_lens,
                         *, num_q_tokens: int = 1) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on any input it does
    not take."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {q.device}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k_pages.dtype} v {v_pages.dtype}:"
                         f" need one of {list(_DTYPES)} for all three")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_pages.shape)} "
                         f"v {tuple(v_pages.shape)}")
    B, KV, rows, hd = q.shape
    P, page, KVp, hdp = k_pages.shape
    if (KVp, hdp) != (KV, hd) or hd not in HEAD_DIMS:
        raise ValueError(f"q {tuple(q.shape)} vs pages {tuple(k_pages.shape)}; "
                         f"head_dim must be one of {HEAD_DIMS}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B \
            or tuple(context_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} for B={B}")
    if num_q_tokens < 1 or rows % num_q_tokens or rows > MAX_ROWS:
        raise ValueError(f"{rows} q rows with num_q_tokens={num_q_tokens} "
                         f"(at most {MAX_ROWS} rows)")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), context_lens.data_ptr(),
                      out.data_ptr(), B, KV, rows, hd, num_q_tokens, page,
                      block_tables.shape[1], 1.0 / math.sqrt(hd),
                      _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    return out
