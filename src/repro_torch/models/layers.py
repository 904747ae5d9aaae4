"""Model primitives of the port: norms, RoPE, blockwise attention, decode
attention against a dense KV cache, KV-cache writes and the SwiGLU MLP.

PyTorch counterparts of ``repro/models/layers.py`` that keep its layouts and
its dtype roundings, so both packages compare like with like:

- attention uses the packed GQA layout: q ``[B, S, G, Qp, hd]``, k/v
  ``[B, S, G, hd]`` with G = kv slots and Qp = q rows per slot;
- q is scaled in q's dtype before the QK product;
- QK and PV products accumulate in float32 (the inputs are upcast, which is
  exact, so a bf16 product is the same as the reference's
  ``preferred_element_type=float32``);
- softmax weights are cast to v's dtype before the PV product.

Where the reference returns an updated cache (JAX arrays are immutable and the
jit wrapper donates the buffer), the functions here write the cache in place
and return the same tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms & activations
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the reference's ``1 + scale`` convention (scales are
    initialised to zero)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE. x: [..., hd] with positions broadcastable to
    x.shape[:-1]."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [hd/2]
    angles = positions.float()[..., None] * freqs                  # [..., hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# blockwise (flash-style) attention, unrolled over blocks
# --------------------------------------------------------------------------
def _pick_block(seq: int, target_blocks: int = 8, floor: int = 512) -> int:
    blk = max(floor, seq // target_blocks)
    while seq % blk != 0:
        blk //= 2
        if blk < 16:
            return seq
    return blk


def block_attention(
    q: torch.Tensor,             # [B, S, G, Qp, hd]
    k: torch.Tensor,             # [B, T, G, hd]
    v: torch.Tensor,             # [B, T, G, hd]
    *,
    causal: bool = True,
    window: int = 0,             # sliding window size (0 = unlimited)
    q_offset: int = 0,           # absolute position of q[0] relative to k[0]
    seq_lens: Optional[torch.Tensor] = None,   # [B] valid key lengths
    q_block: Optional[int] = None,
    kv_block: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention over (q-block, kv-block) pairs; block pairs
    wholly outside the causal or window bound are skipped."""
    B, S, G, Qp, hd = q.shape
    T = k.shape[1]
    qb = q_block or _pick_block(S)
    kb = kv_block or _pick_block(T)
    scale = 1.0 / math.sqrt(hd)
    nq, nk = S // qb, T // kb
    dev = q.device

    out = []
    for i in range(nq):
        qi = (q[:, i * qb:(i + 1) * qb] * scale).to(q.dtype).float()
        q_pos_lo = q_offset + i * qb
        q_pos_hi = q_pos_lo + qb - 1
        m = torch.full((B, G, Qp, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, G, Qp, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, G, Qp, qb, hd), dtype=torch.float32, device=dev)
        for j in range(nk):
            k_pos_lo, k_pos_hi = j * kb, (j + 1) * kb - 1
            if causal and k_pos_lo > q_pos_hi:
                continue  # entirely in the future
            if window > 0 and k_pos_hi < q_pos_lo - window + 1:
                continue  # entirely outside the sliding window
            kj = k[:, j * kb:(j + 1) * kb]
            vj = v[:, j * kb:(j + 1) * kb]
            s_blk = torch.einsum("bqgph,bkgh->bgpqk", qi, kj.float())
            qpos = q_pos_lo + torch.arange(qb, device=dev)
            kpos = k_pos_lo + torch.arange(kb, device=dev)
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            mask_b = mask[None, None, None]
            if seq_lens is not None:
                mask_b = mask_b & (kpos[None, None, None, None, :]
                                   < seq_lens[:, None, None, None, None])
            s_blk = torch.where(mask_b, s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgpqk,bkgh->bgpqh", p.to(v.dtype).float(), vj.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out.append(torch.movedim(o, (1, 2), (2, 3)))   # -> [B, qb, G, Qp, hd]
    return torch.cat(out, dim=1).to(q.dtype)


# --------------------------------------------------------------------------
# decode attention against a dense KV cache (one new token per sequence)
# --------------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,          # [B, G, Qp, hd]
    k_cache: torch.Tensor,    # [B, T, G, hd]
    v_cache: torch.Tensor,    # [B, T, G, hd]
    positions: torch.Tensor,  # [B] current token position (already written)
    *,
    window: int = 0,          # if > 0, cache is a ring buffer of size T == window
) -> torch.Tensor:
    B, T, G, hd = k_cache.shape
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bgph,btgh->bgpt", (q * scale).to(q.dtype).float(),
                     k_cache.float())
    idx = torch.arange(T, device=q.device)
    if window > 0:
        valid = (idx[None, :] <= positions[:, None]) | (positions[:, None] >= T)
    else:
        valid = idx[None, :] <= positions[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgpt,btgh->bgph", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Write one token per sequence into a dense or ring KV cache, in place.

    cache: [B, T, G, hd]; new: [B, G, hd]; positions: [B]. Returns ``cache``.
    """
    T = cache.shape[1]
    slots = positions % T if window > 0 else positions
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slots.long()] = new.to(cache.dtype)
    return cache


def cache_write_full(full: torch.Tensor, g: int, i: int, new: torch.Tensor,
                     positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Write one token per sequence into layer ``(g, i)`` of the stacked cache
    ``[G, n, B, T, KVs, hd]``, in place. Returns ``full``."""
    T = full.shape[3]
    B = full.shape[2]
    slots = positions % T if window > 0 else positions
    rows = torch.arange(B, device=full.device)
    full[g, i, rows, slots.long()] = new.to(full.dtype)
    return full


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def swiglu_mlp(x, w_gate, w_up, w_down, act="silu"):
    f = act_fn(act)
    h = f(x @ w_gate) * (x @ w_up)
    return h @ w_down


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------
def causal_positions(seq_len: int, batch: int,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.int32, device=device)
    return pos.expand(batch, seq_len)
