"""Plain PyTorch versions of the attention kernels: the oracles
``paged_attention_ref`` / ``flash_prefill_ref`` of ``repro/kernels/ref.py``.

The CPU tests run them, ``chip_smoke.py`` holds the CUDA kernels against them
on the card, and ``ops`` dispatches to them for CPU tensors. Both compute in
float32 and cast the result to q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        *, num_q_tokens: int = 1):
    """q: [B, KV, Qt*Qp, hd]; k/v_pages: [num_pages, page, KV, hd];
    block_tables: [B, max_pages]; context_lens: [B] -> out [B, KV, Qt*Qp, hd].

    ``num_q_tokens`` (Qt) > 1: a chunk of query tokens per sequence, token t
    at absolute position ``context_lens[b] - Qt + t`` (causally masked).
    A sequence with ``context_lens == 0`` gets zeros, as the kernels give
    (the JAX oracle returns the mean of V there)."""
    B, KV, rows, hd = q.shape
    page = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, max_pages * page, KV, hd)
    v = v_pages[bt].reshape(B, max_pages * page, KV, hd)
    s = torch.einsum("bgqh,btgh->bgqt", q.float() * scale, k.float())
    idx = torch.arange(max_pages * page, device=q.device)
    qtok = torch.arange(num_q_tokens, device=q.device).repeat_interleave(
        rows // num_q_tokens)                                          # [rows]
    ctx = context_lens.long()
    qpos = ctx[:, None] - num_q_tokens + qtok[None, :]                 # [B, rows]
    valid = idx[None, None, :] <= qpos[:, :, None]                     # [B, rows, T]
    s = torch.where(valid[:, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqt,btgh->bgqh", p, v.float())
    o = torch.where((ctx > 0)[:, None, None, None], o, 0.0)
    return o.to(q.dtype)


def flash_prefill_ref(q, k, v, *, causal=True, q_offset=0, window=0):
    """q: [B, G, S, R, hd] (R = q rows per kv slot); k/v: [B, G, T, hd].
    q row (s, r) attends keys t <= s + q_offset (and within the window)."""
    B, G, S, R, hd = q.shape
    T = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s_ = torch.einsum("bgsrh,bgth->bgsrt", q.float() * scale, k.float())
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s_ = torch.where(mask[None, None, :, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bgsrt,bgth->bgsrh", p, v.float())
    return o.to(q.dtype)
