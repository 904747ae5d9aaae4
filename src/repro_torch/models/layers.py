"""Model primitives of the port: norms (RMS, layer, per-head group), RoPE,
blockwise attention, decode attention against a dense KV cache, KV-cache
writes, the SwiGLU and GELU MLPs and the chunked cross-entropy of training.

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

from repro_torch.distributed.tensor_parallel import NO_REGION, Region

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


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (population variance, as ``jnp.var``), cast back
    to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the trailing head dim (RWKV6), in float32,
    cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (((x - mu) * torch.rsqrt(var + eps)) * scale.float()).to(dt)


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


def gelu_mlp(x, w_in, b_in, w_out, b_out, region: Region = NO_REGION):
    """In a tensor-parallel ``region`` ``w_in``/``b_in`` are the rank's
    columns and ``w_out`` its rows: the partial sums are reduced before the
    replicated ``b_out`` is added, once."""
    h = F.gelu(region.enter(x) @ w_in + b_in, approximate="tanh")
    return region.reduce(h @ w_out) + b_out


def vocab_logits(hidden, w, vocab_size: int, region: Region = NO_REGION):
    """``hidden @ w`` over the padded vocab, pad columns masked to
    ``NEG_INF``. In a tensor-parallel ``region`` ``w`` is the rank's block
    of vocab columns, and the ranks' logits are gathered."""
    lg = region.gather(region.enter(hidden) @ w, -1)
    if lg.shape[-1] > vocab_size:
        lg = lg.masked_fill(torch.arange(lg.shape[-1], device=lg.device)
                            >= vocab_size, NEG_INF)
    return lg


# --------------------------------------------------------------------------
# chunked cross-entropy: never materializes [B, S, V]
# --------------------------------------------------------------------------
def chunked_softmax_xent(
    x: torch.Tensor,         # [B, S, D] final hidden states
    w_vocab: torch.Tensor,   # [D, Vp], or this rank's [D, Vp / tp] columns
    labels: torch.Tensor,    # [B, S] int; -1 = padding
    *,
    num_chunks: int = 8,
    z_loss: float = 0.0,
    vocab_valid: int = 0,    # true vocab size; pad columns masked out of the lse
    region: Region = NO_REGION,
):
    """Returns (sum_loss, num_valid), float32 scalars, over chunks of ``cs``
    positions: ``S // num_chunks``, halved until it divides S, as in the
    reference. Only one chunk's ``[B, cs, Vp]`` logits exist at a time.

    In an active tensor-parallel ``region`` (``distributed/tensor_parallel``)
    ``w_vocab`` is the rank's block ``region.rank`` of the vocab columns:
    ``x`` enters the region, the largest of the ranks' log-sum-exps is
    all-reduced (no gradient), and the ranks' sums of exps and the labels'
    logits are reduced from it. With no region every edge is the identity."""
    x = region.enter(x)
    B, S, D = x.shape
    n = w_vocab.shape[-1]
    lo = region.rank * n
    cs = max(1, S // num_chunks)
    while S % cs:
        cs //= 2
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    cols = lo + torch.arange(n, device=x.device)
    for i in range(S // cs):
        xc = x[:, i * cs:(i + 1) * cs]
        yc = labels[:, i * cs:(i + 1) * cs].long()
        logits = (xc @ w_vocab).float()                      # [B, cs, n]
        if vocab_valid and vocab_valid < lo + n:
            logits = torch.where(cols < vocab_valid, logits, NEG_INF)
        # the log-sum-exp over this rank's columns, then over the ranks'
        # (with no region m is lse and the second line returns it exactly);
        # logsumexp keeps no [B, cs, n] tensor that gather does not keep
        lse = torch.logsumexp(logits, dim=-1)
        m = region.max(lse)
        lse = m + torch.log(region.reduce(torch.exp(lse - m)))
        idx = yc.clamp(min=0) - lo
        mine = (idx >= 0) & (idx < n)
        hit = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        hit = region.reduce(torch.where(mine, hit, 0.0))
        valid = (yc >= 0).float()
        loss = (lse - hit) * valid
        if z_loss > 0:
            loss = loss + z_loss * torch.square(lse) * valid
        total = total + loss.sum()
        count = count + valid.sum()
    return total, count


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------
def causal_positions(seq_len: int, batch: int,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.int32, device=device)
    return pos.expand(batch, seq_len)


def ring_from_sequence(k: torch.Tensor, window: int,
                       seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Arrange the last ``window`` *valid* positions of ``k`` [B, S, ...] into
    ring-buffer slot order (slot i holds the latest valid position p with
    p % window == i), so a prefill of any (possibly padded) length hands decode
    a consistent ring cache. Slots no valid position reaches are zero."""
    B, S = k.shape[:2]
    if seq_lens is None:
        if S < window:
            return F.pad(k, (0, 0) * (k.ndim - 2) + (0, window - S))
        slots = torch.arange(window, device=k.device)
        pos = (S - 1) - ((S - 1 - slots) % window)
        return k.index_select(1, pos)
    slots = torch.arange(window, device=k.device)
    last = (seq_lens.long() - 1)[:, None]                 # [B, 1]
    pos = last - torch.remainder(last - slots[None, :], window)   # [B, W]
    valid = pos >= 0
    pos = pos.clamp(0, S - 1)
    shape = (B, window) + (1,) * (k.ndim - 2)
    gathered = torch.gather(k, 1, pos.reshape(shape).expand(
        (B, window) + tuple(k.shape[2:])))
    return torch.where(valid.reshape(shape), gathered, gathered.new_zeros(()))
