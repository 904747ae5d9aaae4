"""Plain PyTorch versions of the kernels.

- ``paged_attention_ref`` / ``flash_prefill_ref``: the oracles of
  ``repro/kernels/ref.py``; both compute in float32 and cast the result to q's
  dtype.
- ``rwkv6_chunk_plain``: the chunked WKV6 recurrence over a sequence, a
  loop of the one-chunk form that the model computes
  (``repro/models/rwkv6.py::wkv6_chunk``) and the Pallas kernel
  ``repro/kernels/rwkv6_chunk.py`` computes.
- ``rwkv6_chunk_ref``: the token-by-token recurrence, the oracle of
  ``repro/kernels/ref.py::rwkv6_chunk_ref`` that the chunked form is held to.

The CPU tests run them, ``chip_smoke.py`` holds the CUDA kernels against them
on the card, and ``ops`` dispatches to them for CPU tensors.

Three more rehearse the CUDA kernels' own arithmetic on the CPU, and run on
no path (the CPU tests hold them to the oracles above):
- ``flash_prefill_tc_emulation``: the bf16 wgmma prefill kernel.
- ``paged_attention_split_ref``: the split-KV decode kernel's partials and
  their log-sum-exp merge.
- ``rwkv6_chunk_split_emulation``: the WKV kernel's two passes, every
  chunk's own terms first, then the state carry and the outputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention import split_plan
from repro_torch.kernels.rwkv6_chunk import check_chunk

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


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, context_lens,
                              *, num_q_tokens: int = 1,
                              pages_per_split: int | None = None):
    """``paged_attention_ref``'s function computed as the split-KV kernel
    does, in float32: each span of ``pages_per_split`` pages (the wrapper's
    split plan by default) gives a partial (o unnormalised, m, l) in which
    masked keys add nothing; the partials with l > 0 are merged by
    log-sum-exp in split order, as the kernel's last block of each
    (sequence, kv slot) merges them. Rows with no key (``ctx == 0``) get
    zeros."""
    B, KV, rows, hd = q.shape
    page = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    if pages_per_split is None:
        pages_per_split = split_plan(max_pages, page)[0]
    n_split = max(1, -(-max_pages // pages_per_split))
    span = pages_per_split * page
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, max_pages * page, KV, hd).float()
    v = v_pages[bt].reshape(B, max_pages * page, KV, hd).float()
    s = torch.einsum("bgqh,btgh->bgqt", q.float() * (1.0 / math.sqrt(hd)), k)
    idx = torch.arange(max_pages * page, device=q.device)
    qtok = torch.arange(num_q_tokens, device=q.device).repeat_interleave(
        rows // num_q_tokens)
    ctx = context_lens.long()
    qpos = ctx[:, None] - num_q_tokens + qtok[None, :]                 # [B, rows]
    valid = (idx[None, None, :] <= qpos[:, :, None])[:, None]          # [B, 1, rows, T]
    s = torch.where(valid, s, NEG_INF)
    os_, ms, ls = [], [], []
    for i in range(n_split):
        sl = slice(i * span, (i + 1) * span)
        m = s[..., sl].max(dim=-1).values
        p = torch.where(valid[..., sl], torch.exp(s[..., sl] - m[..., None]), 0.0)
        os_.append(torch.einsum("bgqt,btgh->bgqh", p, v[:, sl]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    o, m, l = torch.stack(os_), torch.stack(ms), torch.stack(ls)  # split first
    live = l > 0
    M = torch.where(live, m, NEG_INF).max(dim=0).values
    f = torch.where(live, torch.exp(m - M), 0.0)
    out = (o * f[..., None]).sum(dim=0) / torch.clamp(
        (l * f).sum(dim=0), min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_prefill_tc_emulation(q, k, v, *, causal=True, q_offset=0, window=0,
                               block_n: int = 128, block_m: int = 64):
    """``flash_prefill_ref``'s function computed as the bf16 wgmma kernel
    does: bf16 operands, f32 products, S scaled by log2(e)/sqrt(hd) in f32,
    an online softmax in base 2 over ``block_n``-key tiles, each group of
    ``block_m`` packed rows (a consumer warpgroup) visiting only the tiles
    its own positions can see, and P V as two products with P split into
    bf16 hi = bf16(p) and lo = bf16(p - hi). Returns the f32 result cast
    once to q's dtype."""
    B, G, S, R, hd = q.shape
    T = k.shape[2]
    SR = S * R
    c = torch.tensor(1.0 / math.sqrt(hd) * math.log2(math.e),
                     dtype=torch.float32)
    bf = torch.bfloat16
    qf = q.to(bf).float().reshape(B, G, SR, hd)
    kf, vf = k.to(bf).float(), v.to(bf).float()
    out = torch.empty((B, G, SR, hd), device=q.device)
    for r0 in range(0, SR, block_m):
        r1 = min(SR, r0 + block_m)
        qpos = q_offset + torch.arange(r0, r1, device=q.device) // R
        lo, hi = int(qpos[0]), int(qpos[-1])
        k_end = min(T, hi + 1) if causal else T
        k_first = (max(0, lo - window + 1) // block_n) * block_n if window > 0 else 0
        m = torch.full((B, G, r1 - r0), NEG_INF, device=q.device)
        l = torch.zeros((B, G, r1 - r0), device=q.device)
        acc = torch.zeros((B, G, r1 - r0, hd), device=q.device)
        for k0 in range(k_first, k_end, block_n):
            kpos = torch.arange(k0, min(T, k0 + block_n), device=q.device)
            s = torch.einsum("bgrh,bgth->bgrt", qf[:, :, r0:r1],
                             kf[:, :, k0:k0 + block_n]) * c
            mask = torch.ones((r1 - r0, len(kpos)), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp2(s - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(dim=-1)
            p_hi = p.to(bf).float()
            p_lo = (p - p_hi).to(bf).float()
            vt = vf[:, :, k0:k0 + block_n]
            acc = (acc * corr[..., None]
                   + torch.einsum("bgrt,bgth->bgrh", p_hi, vt)
                   + torch.einsum("bgrt,bgth->bgrh", p_lo, vt))
            m = m_new
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, G, S, R, hd).to(q.dtype)


def _wkv6_chunk_terms(r, k, v, logw, u):
    """What one chunk of the WKV6 recurrence needs of its own inputs only,
    in float32: (r * exp(lde) [B, c, H, K], A @ v [B, c, H, V],
    d_total = exp(ldi[-1]) [B, H, K], U = (k * exp(ldi[-1] - ldi))^T v
    [B, H, K, V])."""
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    c = r.shape[1]
    ldi = torch.cumsum(logw, dim=1)              # inclusive decay log-sums
    lde = ldi - logw                             # exclusive
    r_dec = r * torch.exp(lde)
    # intra-chunk: A[t,j] = sum_k r[t,k] k[j,k] exp(lde[t]-ldi[j]), j < t
    diff = lde[:, :, None] - ldi[:, None, :]     # [B, t, j, H, K]
    tri = (torch.arange(c, device=r.device)[:, None]
           > torch.arange(c, device=r.device)[None, :])[None, :, :, None, None]
    w_decay = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    A = torch.einsum("bthk,bjhk,btjhk->bthj", r, k, w_decay)
    diag = torch.einsum("bthk,bthk,hk->bth", r, k, u)
    A = A + torch.eye(c, device=r.device)[None, :, None, :] * diag[..., None]
    av = torch.einsum("bthj,bjhv->bthv", A, v)
    # state update: S' = diag(d_total) S + sum_j (k_j exp(ldi[-1]-ldi[j])) v_j^T
    d_total = torch.exp(ldi[:, -1])              # [B, H, K]
    k_scaled = k * torch.exp(ldi[:, -1][:, None] - ldi)
    return r_dec, av, d_total, torch.einsum("bjhk,bjhv->bhkv", k_scaled, v)


def _wkv6_output(r_dec, av, state):
    """o = (r * exp(lde)) @ S + A @ v, from the carried state S."""
    return torch.einsum("bthk,bhkv->bthv", r_dec, state) + av


def _wkv6_carry(d_total, U, state):
    """S' = diag(d_total) S + U."""
    return state * d_total[..., None] + U


def _wkv6_one_chunk(r, k, v, logw, u, state):
    """One chunk of the WKV6 recurrence in float32 -> (o f32, new state)."""
    r_dec, av, d_total, U = _wkv6_chunk_terms(r, k, v, logw, u)
    state = state.float()
    return _wkv6_output(r_dec, av, state), _wkv6_carry(d_total, U, state)


def rwkv6_chunk_plain(r, k, v, logw, u, state, *, out_dtype=None, chunk=None):
    """The chunked WKV6 recurrence, all in float32: a loop over chunks of
    ``chunk`` tokens (S by default: one chunk), each the one-chunk form that
    the model computes (``repro/models/rwkv6.py::wkv6_chunk``) and the Pallas
    kernel ``repro/kernels/rwkv6_chunk.py`` computes, carrying the state.

    r/k/logw: [B, S, H, K]; v: [B, S, H, V]; u: [H, K]; state: [B, H, K, V].
    Returns (o [B, S, H, V] in ``out_dtype`` — r's dtype by default, as the
    Pallas kernel writes it — and the state after the last chunk
    [B, H, K, V] in float32). Raises unless ``chunk`` divides S."""
    out_dtype = out_dtype or r.dtype
    S = r.shape[1]
    c = check_chunk(S, chunk)
    outs = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        o, state = _wkv6_one_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl],
                                   u, state)
        outs.append(o)
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.to(out_dtype), state


def rwkv6_chunk_split_emulation(r, k, v, logw, u, state, *, out_dtype=None,
                                chunk=None):
    """``rwkv6_chunk_plain``'s function computed in the CUDA kernel's three
    steps, each with the plain version's per-chunk expressions: the intra
    pass computes every chunk's own terms (r * exp(lde), A @ v, d_total, U)
    without the state; the carry walks the chunks, S_n = d_n S_{n-1} + U_n,
    and is the only serial step; the output pass computes o_n = (r *
    exp(lde))_n @ S_{n-1} + (A @ v)_n for every chunk from the carried
    states. Same arguments and results as ``rwkv6_chunk_plain``."""
    out_dtype = out_dtype or r.dtype
    S = r.shape[1]
    c = check_chunk(S, chunk)
    chunks = [slice(i * c, (i + 1) * c) for i in range(S // c)]
    terms = [_wkv6_chunk_terms(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u)
             for sl in chunks]                                    # intra
    states = [state.float()]
    for _, _, d_total, U in terms:                                # carry
        states.append(_wkv6_carry(d_total, U, states[-1]))
    outs = [_wkv6_output(r_dec, av, s_prev)                       # output
            for (r_dec, av, _, _), s_prev in zip(terms, states)]
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.to(out_dtype), states[-1]


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
