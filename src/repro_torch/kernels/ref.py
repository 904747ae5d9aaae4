"""Plain PyTorch versions of the kernels.

- ``paged_attention_ref`` / ``flash_prefill_ref``: the oracles of
  ``repro/kernels/ref.py``; both compute in float32 and cast the result to q's
  dtype.
- ``rwkv6_chunk_plain``: the chunked form of one WKV6 chunk, as the model
  computes it (``repro/models/rwkv6.py::wkv6_chunk``), and what the Pallas
  kernel ``repro/kernels/rwkv6_chunk.py`` computes.
- ``rwkv6_chunk_ref``: the token-by-token recurrence, the oracle of
  ``repro/kernels/ref.py::rwkv6_chunk_ref`` that the chunked form is held to.

The CPU tests run them, ``chip_smoke.py`` holds the CUDA kernels against them
on the card, and ``ops`` dispatches to them for CPU tensors.
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


def rwkv6_chunk_plain(r, k, v, logw, u, state, *, out_dtype=None):
    """One chunk of the WKV6 recurrence, all in float32.

    r/k/logw: [B, c, H, K]; v: [B, c, H, V]; u: [H, K]; state: [B, H, K, V].
    Returns (o [B, c, H, V] in ``out_dtype`` — r's dtype by default, as the
    Pallas kernel writes it — and the new state [B, H, K, V] in float32)."""
    out_dtype = out_dtype or r.dtype
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    state = state.float()
    c = r.shape[1]
    ldi = torch.cumsum(logw, dim=1)              # inclusive decay log-sums
    lde = ldi - logw                             # exclusive
    # inter-chunk: the carried state's contribution
    o_inter = torch.einsum("bthk,bhkv->bthv", r * torch.exp(lde), state)
    # intra-chunk: A[t,j] = sum_k r[t,k] k[j,k] exp(lde[t]-ldi[j]), j < t
    diff = lde[:, :, None] - ldi[:, None, :]     # [B, t, j, H, K]
    tri = (torch.arange(c, device=r.device)[:, None]
           > torch.arange(c, device=r.device)[None, :])[None, :, :, None, None]
    w_decay = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    A = torch.einsum("bthk,bjhk,btjhk->bthj", r, k, w_decay)
    diag = torch.einsum("bthk,bthk,hk->bth", r, k, u)
    A = A + torch.eye(c, device=r.device)[None, :, None, :] * diag[..., None]
    o = o_inter + torch.einsum("bthj,bjhv->bthv", A, v)
    # state update: S' = diag(d_total) S + sum_j (k_j exp(ldi[-1]-ldi[j])) v_j^T
    d_total = torch.exp(ldi[:, -1])              # [B, H, K]
    k_scaled = k * torch.exp(ldi[:, -1][:, None] - ldi)
    new_state = (state * d_total[..., None]
                 + torch.einsum("bjhk,bjhv->bhkv", k_scaled, v))
    return o.to(out_dtype), new_state


def rwkv6_chunk_ref(r, k, v, logw, u, state):
    """Naive sequential recurrence, in float32. r/k/v/logw: [B, c, H, K];
    u: [H, K]; state: [B, H, K, V] -> (o [B, c, H, V], state)."""
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    state = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t][..., :, None] * v[:, t][..., None, :]       # [B, H, K, V]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = state * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(outs, dim=1), state
