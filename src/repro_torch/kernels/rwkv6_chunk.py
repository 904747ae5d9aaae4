"""RWKV6 chunked-WKV kernel: the Python side of ``csrc/rwkv6_chunk.cu``
(CUDA C++ for sm_90a), which replaces the Pallas kernel
``repro/kernels/rwkv6_chunk.py``. One call per layer: a chunk-parallel pass
(every chunk's A, A v and k^T v) and the state carry, which walks the chunks
in order with the WKV state kept on chip.

Layouts:
  r, k, logw [B, S, H, K]; v [B, S, H, V]; u [H, K]; state [B, H, K, V]
  -> o [B, S, H, V], state after the last chunk [B, H, K, V] (float32)

``S`` is split into chunks of ``chunk`` tokens (``S`` by default: one
chunk, the Pallas kernel's contract); each chunk computes what the
one-chunk kernel computes, so one call over n chunks equals n chained
one-chunk calls bit for bit. r/k/v/logw may be strided views (the
model's ``[B, S, H, K]`` projections, or slices of them); only the last dim
must be contiguous, and every row must start on 16 bytes (the kernel loads
them by TMA). r, k and v are float32 or bfloat16, all three alike;
logw is float32 or r's dtype; u and state are contiguous float32. ``o`` is
written in ``out_dtype``, r's dtype by default as the Pallas kernel writes
it (the model asks for float32, as its ``wkv6_chunk`` keeps it). The
passes hand each chunk's record over through a float32 workspace that the
wrapper allocates (``rwkv6_chunk_workspace`` floats).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)
MAX_HEAD_DIM = 64

_launch = None
_workspace = None


def _launcher():
    global _launch, _workspace
    if _launch is None:
        lib = build.load("rwkv6_chunk")
        fn = lib.rwkv6_chunk_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.rwkv6_chunk_workspace
        ws.argtypes = [ctypes.c_int] * 6
        ws.restype = ctypes.c_longlong
        _launch, _workspace = fn, ws
    return _launch


def check_chunk(S: int, chunk: int | None) -> int:
    """The chunk length for a sequence of S tokens (S when ``chunk`` is
    None); raises unless it divides S."""
    c = S if chunk is None else chunk
    if c <= 0 or S % c:
        raise ValueError(f"sequence length {S} is not a multiple of chunk {c}")
    return c


def _check(r, k, v, logw, u, state, out_dtype, chunk):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_chunk_cuda needs CUDA tensors, got {dev}")
    names = ("r", "k", "v", "logw", "u", "state")
    for name, x in zip(names, (r, k, v, logw, u, state)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, r on {dev}")
    if (r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype
            or logw.dtype not in (torch.float32, r.dtype)
            or u.dtype != torch.float32 or state.dtype != torch.float32
            or out_dtype not in _DTYPES):
        raise ValueError(
            f"dtypes r {r.dtype} k {k.dtype} v {v.dtype} logw {logw.dtype} "
            f"u {u.dtype} state {state.dtype} out {out_dtype}: r/k/v must be "
            f"one of {list(_DTYPES)} alike, logw float32 or r's dtype, u and "
            f"state float32, out one of {list(_DTYPES)}")
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"shapes r {tuple(r.shape)} v {tuple(v.shape)}: "
                         f"need [B, S, H, K] and [B, S, H, V]")
    B, S, H, K = r.shape
    V = v.shape[3]
    if (k.shape != r.shape or logw.shape != r.shape
            or tuple(v.shape[:3]) != (B, S, H) or tuple(u.shape) != (H, K)
            or tuple(state.shape) != (B, H, K, V)):
        raise ValueError(
            f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"logw {tuple(logw.shape)} u {tuple(u.shape)} "
            f"state {tuple(state.shape)} do not agree")
    c = check_chunk(S, chunk)
    if c not in CHUNKS:
        raise ValueError(f"chunk length {c} must be one of {CHUNKS}")
    for name, d in (("K", K), ("V", V)):
        if d > MAX_HEAD_DIM or d % 16:
            raise ValueError(f"head dim {name} = {d} must be a multiple of 16 "
                             f"and at most {MAX_HEAD_DIM}")
    for name, x in zip(names[:4], (r, k, v, logw)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        steps = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if x.data_ptr() % 16 or any(st * x.element_size() % 16 for st in steps):
            raise ValueError(f"{name}'s rows must start on 16-byte boundaries "
                             f"(strides {x.stride()}, {x.element_size()}-byte "
                             f"elements)")
    if not (u.is_contiguous() and state.is_contiguous()):
        raise ValueError("u and state must be contiguous")
    return c


def rwkv6_chunk_cuda(r, k, v, logw, u, state, *, out_dtype=None, chunk=None):
    """Launch the two passes on the current stream; raises on any input they
    do not take. Returns (o, state after the last chunk), both new
    tensors."""
    out_dtype = out_dtype or r.dtype
    c = _check(r, k, v, logw, u, state, out_dtype, chunk)
    B, S, H, K = r.shape
    V = v.shape[3]
    out = torch.empty((B, S, H, V), dtype=out_dtype, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    launch = _launcher()
    ws = torch.empty(_workspace(B, H, S // c, c, K, V), dtype=torch.float32,
                     device=r.device)
    strides = [s for x in (r, k, v, logw) for s in x.stride()[:3]]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), state.data_ptr(), out.data_ptr(),
                 s_out.data_ptr(), ws.data_ptr(), B, S // c, c, H, K, V,
                 *strides, _DTYPES[r.dtype], _DTYPES[logw.dtype],
                 _DTYPES[out_dtype], stream)
    if err:
        raise RuntimeError(f"rwkv6_chunk kernel launch failed: CUDA error {err}")
    return out, s_out
