"""Flash-attention prefill kernel: the Python side of
``csrc/flash_prefill.cu`` (CUDA C++ for sm_90a), which replaces the Pallas
kernel ``repro/kernels/flash_prefill.py``.

Layouts:
  q [B, G, S, R, hd]  (G = kv slots, R = q rows per slot)
  k [B, G, T, hd], v [B, G, T, hd]; T >= q_offset + S for causal prefixes

q, k and v may be strided views (the model hands over ``movedim`` views of
its ``[B, S, G, ...]`` projections); only the head dim must be contiguous.
The output is a new contiguous ``[B, G, S, R, hd]`` tensor in q's dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_launch = None


def _launcher():
    global _launch
    if _launch is None:
        fn = build.load("flash_prefill").flash_prefill_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def flash_prefill_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                       q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on any input it does
    not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_cuda needs CUDA tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"devices q {q.device} k {k.device} v {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: need "
                         f"one of {list(_DTYPES)} for all three")
    if q.ndim != 5 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, G, S, R, hd = q.shape
    if tuple(k.shape[:2]) != (B, G) or k.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"q {tuple(q.shape)} vs k/v {tuple(k.shape)}; "
                         f"head_dim must be one of {HEAD_DIMS}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"that are multiples of {vec} elements")
    T = k.shape[2]
    out = torch.empty((B, G, S, R, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, G, S, R, T, hd, *q.stride()[:4], *k.stride()[:3],
                      *v.stride()[:3], int(causal), window, q_offset,
                      1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {err}")
    return out
