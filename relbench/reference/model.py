"""Plain reference of the served dense transformers, and the comparison
that decides a run's ``correct``.

The published layer equations of Qwen2.5 and InternLM2 (the InternVL2
backbone): RMSNorm, split-half RoPE (theta from the config), grouped-query
attention with causal masking, q/k/v biases where the config has them, a
SwiGLU MLP, an untied LM head. Plain PyTorch in float32 with TF32 off, no
cache and no padding: each sequence is run whole (several side by side,
each attending only to itself), layer by layer, from the raw bf16 weights
the benchmark drew (``relbench/weights.py``: gains stored
as offsets from one, query heads packed ``[kv_heads, q_per_kv]``), each
layer cast to float32 only while it runs, since neither model fits the
card in float32.

``quant="fp8"`` is the control: the same forward with every matrix
product's weights (per output channel) and activations (per token)
rounded to float8 e4m3, the precision below the configuration's bf16.

This module imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch

FP8_MAX = 448.0
MLP_ROWS = 4096            # tokens per MLP block: bounds the f32 intermediates
VOCAB_ROWS = 1024          # positions per LM-head block
VOCAB_COLS = 16384         # vocabulary columns per LM-head block


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products in float32, not TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 with one scale per slice along ``dim``
    (the reduction axis of the product it feeds), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The forward pass of one configuration over given weights."""

    def __init__(self, cfg: dict, weights: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.cfg = cfg
        self.w = weights
        self.quant = quant
        self.H = cfg["num_attention_heads"]
        self.KV = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.L = cfg["num_hidden_layers"]

    # ------------------------------------------------------------ pieces
    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        """A stored weight [in, out] as the products take it."""
        w = w.float()
        return _fp8(w, 0) if self.quant == "fp8" else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [T, in] @ w [in, out] (``_weight``'s), in float32."""
        return (_fp8(x, -1) if self.quant == "fp8" else x) @ w

    def _norm(self, x: torch.Tensor, gain_offset: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + gain_offset.float())

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [n, heads, hd]; split-half rotation by position."""
        half = self.hd // 2
        inv = 1.0 / (self.theta ** (torch.arange(0, half, device=x.device,
                                                 dtype=torch.float32) * 2 / self.hd))
        ang = pos.float()[:, None, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """One sequence: q [n, H, hd], k/v [n, KV, hd] -> [n, H*hd]."""
        n = q.shape[0]
        rep = self.H // self.KV
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(self.hd)
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("hqk,khd->qhd", p, v).reshape(n, -1)

    def _layer(self, i: int, x: torch.Tensor, lens: Sequence[int],
               pos: torch.Tensor) -> torch.Tensor:
        b = self.w["blocks"]
        D = x.shape[-1]
        f = lambda name: self._weight(b[name][i, 0].reshape(D, -1))
        h = self._norm(x, b["ln1"][i, 0])
        q = self._mm(h, f("wq"))
        k = self._mm(h, f("wk"))
        v = self._mm(h, f("wv"))
        if "bq" in b:
            q = q + b["bq"][i, 0].float().reshape(-1)
            k = k + b["bk"][i, 0].float().reshape(-1)
            v = v + b["bv"][i, 0].float().reshape(-1)
        q = self._rope(q.view(-1, self.H, self.hd), pos)
        k = self._rope(k.view(-1, self.KV, self.hd), pos)
        v = v.view(-1, self.KV, self.hd)
        outs, start = [], 0
        for n in lens:
            sl = slice(start, start + n)
            outs.append(self._attention(q[sl], k[sl], v[sl]))
            start += n
        wo = self._weight(b["wo"][i, 0].reshape(-1, D))
        x = x + self._mm(torch.cat(outs), wo)
        wg, wu = f("w_gate"), f("w_up")
        wd = self._weight(b["w_down"][i, 0])
        for s in range(0, x.shape[0], MLP_ROWS):
            blk = x[s:s + MLP_ROWS]
            h = self._norm(blk, b["ln2"][i, 0])
            m = torch.nn.functional.silu(self._mm(h, wg)) * self._mm(h, wu)
            x[s:s + MLP_ROWS] = blk + self._mm(m, wd)
        return x

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Run every sequence of ``seqs`` whole; return, per sequence, the
        float32 logits ``[len(wanted[j]), vocab]`` at the positions
        ``wanted[j]``."""
        dev = self.w["embed"].device
        with exact_f32():
            lens = [len(s) for s in seqs]
            toks = torch.tensor([t for s in seqs for t in s], device=dev)
            pos = torch.cat([torch.arange(n, device=dev) for n in lens])
            x = self.w["embed"][toks].float()
            for i in range(self.L):
                x = self._layer(i, x, lens, pos)
            starts = [sum(lens[:j]) for j in range(len(lens))]
            rows = torch.tensor([starts[j] + p for j, w in enumerate(wanted)
                                 for p in w], device=dev, dtype=torch.long)
            h = self._norm(x[rows], self.w["final_norm"])
            head = self.w["lm_head"]
            cols = []
            for c in range(0, head.shape[1], VOCAB_COLS):
                w = self._weight(head[:, c:c + VOCAB_COLS])
                cols.append(torch.cat([self._mm(h[s:s + VOCAB_ROWS], w)
                                       for s in range(0, h.shape[0], VOCAB_ROWS)]))
            out = torch.cat(cols, dim=1)
        counts = [len(w) for w in wanted]
        return list(torch.split(out, counts))


def served_positions(prompt_len: int, served: int) -> List[int]:
    """Positions whose logits chose each served token: the prompt's last,
    then each fed output token's."""
    return list(range(prompt_len - 1, prompt_len - 1 + served))


def served_gap(ref_logits: torch.Tensor, served: Sequence[int]) -> float:
    """Widest gap by which a served token's logit lies below the
    reference's best at its position."""
    tok = torch.as_tensor(list(served), device=ref_logits.device)
    best = ref_logits.max(-1).values
    return float((best - ref_logits.gather(1, tok[:, None])[:, 0]).max())


def control_gap(ref_logits: torch.Tensor, ctl_logits: torch.Tensor) -> float:
    """The same gap for the tokens the control puts first."""
    return served_gap(ref_logits, ctl_logits.argmax(-1).tolist())
