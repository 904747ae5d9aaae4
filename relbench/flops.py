"""Operations and bytes of the served steps, from shapes and real lengths,
and the published peaks of one NVIDIA H100 they are held against.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity): 989e12 FLOP/s in
bf16, 3.35e12 B/s of HBM3 (the constants of the port's
``launch/roofline.py``, copied here so that the yardstick stays put).

Counts follow what the inputs need, not what a kernel happens to compute:
a row's real prompt length (no padding to a bucket), a decode row's real
context, each input byte read once and each output byte written once. A
matrix product of ``m x k`` by ``k x n`` is ``2 m k n`` operations.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = 989e12      # bf16 dense, FLOP/s
HBM_BW = 3.35e12         # B/s
BF16 = 2                 # bytes per element of the served dtype


def layer_params(d: Dict[str, int]) -> int:
    """Weights of one layer's matrix products (q, k, v, o, gate, up, down)."""
    D, H, KV, hd, F = d["D"], d["H"], d["KV"], d["hd"], d["F"]
    return D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F


def causal_pairs(n: int) -> int:
    """Query-key pairs of a causal pass over ``n`` tokens."""
    return n * (n + 1) // 2


# ---------------------------------------------------------------- kernels
def flash_prefill_call(d: Dict[str, int], lens: Sequence[int]) -> Dict[str, float]:
    """One ``flash_prefill`` call (one layer) over rows of real lengths
    ``lens``: QK^T and PV over the causal pairs; q, k, v read, o written."""
    H, KV, hd = d["H"], d["KV"], d["hd"]
    flops = sum(4 * H * hd * causal_pairs(n) for n in lens)
    byts = sum(n * (2 * H + 2 * KV) * hd * BF16 for n in lens)
    return {"flops": float(flops), "bytes": float(byts)}


def paged_attention_call(d: Dict[str, int], ctx: Sequence[int]) -> Dict[str, float]:
    """One ``paged_attention`` call (one layer) of a decode step over rows
    attending ``ctx`` cached tokens: q read and o written once per row, each
    row's K and V pages once."""
    H, KV, hd = d["H"], d["KV"], d["hd"]
    flops = sum(4 * H * hd * c for c in ctx)
    byts = sum(2 * H * hd * BF16 + 2 * c * KV * hd * BF16 for c in ctx)
    return {"flops": float(flops), "bytes": float(byts)}


def bound_s(work: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of operations over
    peak and bytes over bandwidth."""
    return max(work["flops"] / PEAK_FLOPS, work["bytes"] / HBM_BW)


# ---------------------------------------------------------------- model steps
def prefill_flops(d: Dict[str, int], lens: Sequence[int]) -> float:
    """Model operations of a prefill over rows of real lengths ``lens``:
    every layer's products and attention for every prompt token, and the LM
    head for each row's last token (the only logits a prefill returns)."""
    per_tok = 2 * layer_params(d) * d["L"]
    attn = flash_prefill_call(d, lens)["flops"] * d["L"]
    return float(per_tok * sum(lens) + attn + len(lens) * 2 * d["D"] * d["V"])


def decode_flops(d: Dict[str, int], ctx: Sequence[int]) -> float:
    """Model operations of one decode step over rows attending ``ctx``
    tokens (the new token's included)."""
    per_row = 2 * layer_params(d) * d["L"] + 2 * d["D"] * d["V"]
    attn = paged_attention_call(d, ctx)["flops"] * d["L"]
    return float(per_row * len(ctx) + attn)

