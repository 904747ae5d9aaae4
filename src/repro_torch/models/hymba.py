"""Hymba: each layer runs sliding-window attention heads and Mamba (selective
SSM) heads in parallel on the same input; the branch outputs are normalized
and averaged (arXiv:2411.13676). The PyTorch counterpart of
``repro/models/hymba.py::HymbaModel``.

The attention half is ``DenseTransformer``'s window layers (``attn_kind
'swa'``: ring-buffer ``k_win``/``v_win`` caches); the per-layer hooks
``_layer_seq`` / ``_layer_decode`` add the Mamba branch beside it. Its
discretization (``dt``, ``dA``, ``dBx``, ``C``) and the SSM state stay in
float32 in a bf16 model, as in the reference. The selective scan is chunked
as the reference's (``_ssm_chunk_size``), with the affine recurrence
``h -> dA * h + dBx`` composed inside each chunk by a log-depth
(Hillis–Steele) scan in place of ``jax.lax.associative_scan``: the same
combine, other float32 summation orders. No kernel of this repo is on these
paths: the scan is plain torch, as the reference's is plain jnp.

Caches: the window rings, ``conv [G, B, d_inner, ssm_conv - 1]`` (the last
``ssm_conv - 1`` *valid* inputs of the causal conv, model dtype) and ``ssm
[G, B, d_inner, ssm_state]`` (float32). Both Mamba entries fold every decode
step into the row (``RECURRENT_CACHE``), so the dense executor keeps
off-batch rows as they were.

On a mesh the attention half runs as ``DenseTransformer``'s, and the Mamba
branch on the rank's ``d_inner`` channels: its block of ``m_conv_w``,
``m_alog``, ``m_bdt``, ``m_dskip``, the columns of ``m_wdt`` and the rows of
``m_wx`` and ``m_out`` (each row-parallel product reduced), with the
``conv`` and ``ssm`` caches sharded on ``d_inner``. ``m_in`` keeps the
reference's placement, ``Shard`` on its 2·d_inner columns, so a rank's block
of ``x @ m_in`` holds columns of ``x_m`` or of ``z``, not its own of both:
``_mamba_proj`` gathers it and takes the rank's block of each half.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.param_utils import t
from repro_torch.models.transformer import DenseTransformer


def _ssm_chunk_size(seq: int) -> int:
    c = max(64, seq // 128)
    while seq % c:
        c //= 2
    return max(c, 1)


def _affine_scan(dA, dBx):
    """Inclusive scan of the maps ``h -> dA[t] * h + dBx[t]`` along axis 1,
    log-depth: returns (A_cum, B_cum) with ``h_t = A_cum[t] * h_0 + B_cum[t]``.
    Each step composes position t with position t - d, the reference's
    ``combine((a1, b1), (a2, b2)) = (a1 * a2, b1 * a2 + b2)``."""
    A, Bc = dA, dBx
    c, d = A.shape[1], 1
    while d < c:
        A, Bc = (torch.cat([A[:, :d], A[:, :-d] * A[:, d:]], dim=1),
                 torch.cat([Bc[:, :d], Bc[:, :-d] * A[:, d:] + Bc[:, d:]], dim=1))
        d *= 2
    return A, Bc


def selective_scan_chunked(ssm_inputs_fn, x_conv, h0):
    """Chunked selective scan. ``ssm_inputs_fn(x_chunk, offset) -> (dA, dBx,
    C)`` is evaluated per chunk, so the [B, c, Di, N] discretization tensors
    never exist for the whole sequence. Returns (y [B, S, Di], h_final)."""
    S = x_conv.shape[1]
    c = _ssm_chunk_size(S)
    ys = []
    h = h0
    for i in range(S // c):
        dA, dBx, C = ssm_inputs_fn(x_conv[:, i * c:(i + 1) * c], i * c)
        A_cum, B_cum = _affine_scan(dA, dBx)
        hs = A_cum * h[:, None] + B_cum                      # [B, c, Di, N]
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


class HymbaModel(DenseTransformer):
    """DenseTransformer (swa attention) + a parallel Mamba branch per layer."""

    # no kernel of this repo: block attention and the plain scan
    KERNELS = ()
    # the conv and SSM state fold every decode step into the row
    RECURRENT_CACHE = True

    def __init__(self, cfg, pc=None):
        super().__init__(cfg, pc)
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.dt_rank = max(16, cfg.d_model // 16)

    def supports_paged(self) -> bool:
        return False   # hybrid cache (ring attention + SSM state), not paged

    # ---------------------------------------------------------------- params
    def templates(self):
        base = super().templates()
        cfg = self.cfg
        G, Pg, D = self.n_groups, self.group, cfg.d_model
        Di, N, ck, dtr = self.d_inner, cfg.ssm_state, cfg.ssm_conv, self.dt_rank
        base["blocks"].update({
            "m_in": t((G, Pg, D, 2 * Di), (None, None, None, "d_inner"), fan_in=D),
            "m_conv_w": t((G, Pg, Di, ck), (None, None, "d_inner", None), fan_in=ck),
            "m_conv_b": t((G, Pg, Di), (None, None, "d_inner"), "zeros"),
            "m_alog": t((G, Pg, Di, N), (None, None, "d_inner", None), "zeros"),
            "m_wx": t((G, Pg, Di, dtr + 2 * N), (None, None, "d_inner", None), fan_in=Di),
            "m_wdt": t((G, Pg, dtr, Di), (None, None, None, "d_inner"), fan_in=dtr),
            "m_bdt": t((G, Pg, Di), (None, None, "d_inner"), "zeros"),
            "m_dskip": t((G, Pg, Di), (None, None, "d_inner"), "ones"),
            "m_out": t((G, Pg, Di, D), (None, None, "d_inner", None), fan_in=Di),
            "fuse_na": t((G, Pg, D), (None, None, None), "zeros"),
            "fuse_nm": t((G, Pg, D), (None, None, None), "zeros"),
        })
        return base

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device=None):
        out = super().init_cache(batch, max_len, device)
        cfg = self.cfg
        out["conv"] = torch.zeros((self.n_groups, batch, self.d_inner,
                                   cfg.ssm_conv - 1), dtype=self.dtype,
                                  device=device)
        out["ssm"] = torch.zeros((self.n_groups, batch, self.d_inner,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device)
        return out

    def cache_specs(self):
        specs = super().cache_specs()
        specs["conv"] = self.pc.spec(None, "batch", "d_inner", None)
        specs["ssm"] = self.pc.spec(None, "batch", "d_inner", None)
        return specs

    def cache_slot_axes(self) -> Dict[str, int]:
        return dict(super().cache_slot_axes(), conv=1, ssm=1)

    # ---------------------------------------------------------------- mamba branch
    def _mamba_proj(self, pp, p, x):
        """x -> (x_m, z), each the rank's [..., Di/tp] channels: ``xz`` is
        gathered whole (``gather_scatter``: each rank's gradient of it is
        its own channels' part) before the halves are cut."""
        region = self._region
        xz = region.gather_scatter(region.enter(x) @ pp["m_in"][p])
        x_m, z = torch.chunk(xz, 2, dim=-1)
        return region.cols(x_m), region.cols(z)

    def _mamba_xp(self, pp, p, x_conv):
        """x_conv [..., Di] @ m_wx -> [..., dt_rank + 2N]. m_wx is
        row-parallel: the partial sums are reduced; every rank then uses the
        sum on its own channels, so its gradient is reduced too. Over the
        whole sequence at once: one all-reduce per layer, not per chunk."""
        region = self._region
        return region.enter(region.reduce(x_conv @ pp["m_wx"][p]))

    def _mamba_ssm_inputs(self, pp, p, x_conv, xp, seq_lens=None,
                          offset: int = 0):
        """x_conv: [..., Di] post-conv post-silu, xp its ``_mamba_xp`` ->
        (dA, dBx, C), float32."""
        cfg = self.cfg
        N, dtr = cfg.ssm_state, self.dt_rank
        dt = F.softplus((xp[..., :dtr] @ pp["m_wdt"][p]).float()
                        + pp["m_bdt"][p].float())                 # [..., Di]
        if seq_lens is not None:
            pos = offset + torch.arange(x_conv.shape[1], device=x_conv.device)
            dt = dt * (pos[None, :] < seq_lens[:, None]).float()[..., None]
        Bt = xp[..., dtr:dtr + N].float()
        Ct = xp[..., dtr + N:].float()
        A = -torch.exp(pp["m_alog"][p].float())                  # [Di, N]
        dA = torch.exp(dt[..., None] * A)                        # [..., Di, N]
        dBx = dt[..., None] * Bt[..., None, :] * x_conv.float()[..., None]
        return dA, dBx, Ct

    def _mamba_seq(self, pp, p, x, seq_lens=None):
        """x: [B, S, D] -> (out [B, S, D], conv_tail, h_final). Pad tokens
        freeze the SSM state (dt := 0, so dA = 1 and dBx = 0)."""
        cfg = self.cfg
        B, S, D = x.shape
        x_m, z = self._mamba_proj(pp, p, x)
        ck = cfg.ssm_conv
        pad = F.pad(x_m, (0, 0, ck - 1, 0))
        w = pp["m_conv_w"][p]
        conv = sum(pad[:, i:i + S] * w[:, i] for i in range(ck))
        x_conv = F.silu((conv + pp["m_conv_b"][p]).float()).to(x.dtype)
        h0 = torch.zeros((B, x_m.shape[-1], cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        xp = self._mamba_xp(pp, p, x_conv)
        y, hS = selective_scan_chunked(
            lambda xc, off: self._mamba_ssm_inputs(
                pp, p, xc, xp[:, off:off + xc.shape[1]], seq_lens=seq_lens,
                offset=off),
            x_conv, h0)
        y = y + pp["m_dskip"][p].float() * x_conv.float()
        out = self._region.reduce((y.to(x.dtype) * F.silu(z)) @ pp["m_out"][p])
        if seq_lens is None:
            if S >= ck - 1:
                conv_tail = x_m[:, S - (ck - 1):].transpose(1, 2)
            else:
                conv_tail = F.pad(x_m, (0, 0, ck - 1 - S, 0)).transpose(1, 2)
        else:
            # the last ck-1 *valid* inputs of each sequence
            offs = torch.arange(ck - 1, device=x.device) - (ck - 1)
            at = seq_lens.long()[:, None] + offs[None, :]          # [B, ck-1]
            idx = at.clamp(0, S - 1)[..., None].expand(B, ck - 1, x_m.shape[-1])
            tail = torch.gather(x_m, 1, idx)
            tail = torch.where((at >= 0)[..., None], tail, tail.new_zeros(()))
            conv_tail = tail.transpose(1, 2)
        return out, conv_tail.to(self.dtype), hS

    def _mamba_decode(self, pp, p, x, conv_state, h):
        """x: [B, D]; conv_state: [B, Di, ck-1]; h: [B, Di, N]."""
        x_m, z = self._mamba_proj(pp, p, x)
        window = torch.cat([conv_state, x_m[..., None]], dim=-1)   # [B, Di, ck]
        conv = torch.einsum("bdk,dk->bd", window.float(),
                            pp["m_conv_w"][p].float())
        x_conv = F.silu(conv + pp["m_conv_b"][p].float()).to(x.dtype)
        dA, dBx, Ct = self._mamba_ssm_inputs(pp, p, x_conv,
                                             self._mamba_xp(pp, p, x_conv))
        h_new = dA * h + dBx                                       # [B, Di, N]
        y = torch.einsum("bdn,bn->bd", h_new, Ct)
        y = y + pp["m_dskip"][p].float() * x_conv.float()
        out = self._region.reduce((y.to(x.dtype) * F.silu(z)) @ pp["m_out"][p])
        return out, window[..., 1:].to(self.dtype), h_new

    # ---------------------------------------------------------------- fused layers
    def _fuse(self, pp, p, x, attn, mamba):
        """Both branches normalized and averaged into the residual, then the
        MLP -> (x, aux)."""
        cfg = self.cfg
        fused = 0.5 * (L.rmsnorm(attn, pp["fuse_na"][p], cfg.norm_eps)
                       + L.rmsnorm(mamba, pp["fuse_nm"][p], cfg.norm_eps))
        x = x + fused
        h = L.rmsnorm(x, pp["ln2"][p], cfg.norm_eps)
        mlp, a = self._mlp(pp, p, h)
        return x + mlp, a

    def _layer_seq(self, pp, p: int, x, positions, seq_lens, kind: str):
        h = L.rmsnorm(x, pp["ln1"][p], self.cfg.norm_eps)
        attn, kv = self._mixer_seq(pp, p, h, positions, seq_lens, kind)
        mamba, conv_tail, hS = self._mamba_seq(pp, p, h, seq_lens=seq_lens)
        x, a = self._fuse(pp, p, x, attn, mamba)
        return x, a, kv, {"conv": conv_tail, "ssm": hS}

    def _layer_decode(self, pp, p: int, x, positions, cache, g: int):
        h = L.rmsnorm(x, pp["ln1"][p], self.cfg.norm_eps)
        attn = self._attn_decode_inplace(pp, p, h, positions, self.kinds[p],
                                         cache, g)
        mamba, conv_new, h_new = self._mamba_decode(
            pp, p, h, cache["conv"][g], cache["ssm"][g])
        cache["conv"][g] = conv_new
        cache["ssm"][g] = h_new
        x, _ = self._fuse(pp, p, x, attn, mamba)
        return x
