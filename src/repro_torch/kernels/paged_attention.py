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

Split plan (``split_plan``): the block table is cut into ``n_split`` spans
of ``pages_per_split`` pages, about ``SPLIT_TOKENS`` tokens each, from
``block_tables.shape[1]`` and the page size alone (no host sync on the
context lengths). One block per (split, kv slot, sequence) streams its span
through a TMA-fed shared-memory ring; with ``n_split > 1`` the blocks write
float32 partials into a workspace that the wrapper allocates with
``torch.empty`` (``o`` [B, KV, n_split, rows, hd], ``m`` and ``l``
[B, KV, n_split, rows]), and the last block of each (sequence, kv slot) to
finish, found through an int32 arrival counter, merges them by log-sum-exp:
one launch per call. The counters (``arrival_counters``) are kept per device
and are zero between launches (the last block resets its own), so no call
clears them; calls that share them must run on one stream. A CUDA graph
keeps the address it captured: the paged executor sizes them when it is
built, a capture that needs more raises, and a buffer replaced by a larger
one outside a capture is kept for the graphs captured on it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_ROWS = 32          # Qt * Qp rows per (sequence, kv slot)
SPLIT_TOKENS = 256     # tokens per split of the context

_launch = None
_counters = {}         # device index -> int32 arrival counters, all zero
_retired = []          # replaced counters: earlier graphs still launch on them


def _launcher():
    global _launch
    if _launch is None:
        fn = build.load("paged_attention").paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def split_plan(max_pages: int, page: int) -> tuple:
    """(pages_per_split, n_split) for a block table of ``max_pages`` pages of
    ``page`` tokens: spans of ``SPLIT_TOKENS`` tokens (at least one page),
    as many as cover the table (one for an empty table)."""
    if max_pages < 0 or page < 1:
        raise ValueError(f"max_pages {max_pages} must be >= 0 and page {page} >= 1")
    pages_per_split = max(1, SPLIT_TOKENS // page)
    return pages_per_split, max(1, -(-max_pages // pages_per_split))


def arrival_counters(device, n: int) -> torch.Tensor:
    """The device's int32 arrival counters, at least ``n`` of them, all zero:
    grown (a new zeroed buffer) when a call needs more, which a CUDA graph's
    capture may not do. The kernel leaves them zero, so they are never
    cleared again."""
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a captured paged_attention launch needs {n} arrival "
                f"counters, {0 if buf is None else buf.numel()} were reserved "
                f"(arrival_counters before the capture)")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


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
    max_pages = block_tables.shape[1]
    pages_per_split, n_split = split_plan(max_pages, page)
    out = torch.empty_like(q)
    ws = [None] * 4
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        ws_o = torch.empty((B, KV, n_split, rows, hd), **f32)
        ws_m = torch.empty((B, KV, n_split, rows), **f32)
        ws_l = torch.empty((B, KV, n_split, rows), **f32)
        counters = arrival_counters(q.device, B * KV)
        ws = [ws_o.data_ptr(), ws_m.data_ptr(), ws_l.data_ptr(),
              counters.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), context_lens.data_ptr(),
                      out.data_ptr(), *ws, B, KV, rows, hd, num_q_tokens, page,
                      max_pages, P, pages_per_split, n_split,
                      1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    return out
