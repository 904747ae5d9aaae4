"""Sequence-parallel (context-parallel) decode, the PyTorch counterpart of
``repro/models/seq_parallel.py``.

The baseline TP decode shards the KV cache on *kv-head slots*, which forces
head duplication/padding when kv_heads < TP. Here the cache is sharded on the
*sequence* dim instead (flash-decoding style): every model rank holds S/TP
tokens of ALL true kv heads, computes partial attention for all true Q heads
over its chunk, and the ranks merge with the exact log-sum-exp combine (an
all-reduce max, then an all-reduce sum of numerator and denominator).
Projections stay tensor-parallel: the qkv weights shard the *input* D dim,
the o-projection the H*hd contraction dim.

The model runs on a ``DeviceMesh`` (``mesh``): parameters and cache are
DTensors placed by ``param_specs()`` / ``cache_specs()``, and every rank
computes on its own shards with explicit collectives on the mesh's model
group, where the reference leaves them to GSPMD. Per layer they are five
all-reduces: the QKV projections' partial sums (one buffer), the attention
merge's max and its sums, the o-projection's partial sums and the MLP's
(its ``ff`` dim is sharded); per step two more: the vocab-sharded embedding
lookup (an all-reduce) and the vocab-sharded logits (an all-gather).

Prefill runs on the baseline packed path; ``reshard_cache_from_packed``
converts its cache once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (
    ParallelConfig, dp_rank, local_tree, place_tree, placements)
from repro_torch.models import layers as L
from repro_torch.models.param_utils import t
from repro_torch.models.transformer import LOCAL_ROPE_THETA, DenseTransformer


class SeqParallelDenseTransformer(DenseTransformer):
    """Decode-path variant with a sequence-sharded KV cache."""

    def __init__(self, cfg: ModelConfig, pc: Optional[ParallelConfig] = None,
                 mesh=None):
        super().__init__(cfg, pc)
        self.mesh = mesh
        if (cfg.num_heads * cfg.head_dim) % max(self.pc.tp, 1):
            raise ValueError("o-projection contraction dim must divide TP")

    # ------------------------------------------------------------- params
    def templates(self):
        base = super().templates()
        cfg = self.cfg
        G, Pg, D = self.n_groups, self.group, cfg.d_model
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        # canonical (unpacked, unduplicated) attention weights; model-parallel
        # on the *contraction* dims ('ff' resolves to the model axis)
        blocks = base["blocks"]
        blocks["wq"] = t((G, Pg, D, H, hd), (None, None, "ff", None, None), fan_in=D)
        blocks["wk"] = t((G, Pg, D, KV, hd), (None, None, "ff", None, None), fan_in=D)
        blocks["wv"] = t((G, Pg, D, KV, hd), (None, None, "ff", None, None), fan_in=D)
        blocks["wo"] = t((G, Pg, H * hd, D), (None, None, "ff", None),
                         fan_in=H * hd)
        if cfg.qkv_bias:
            blocks["bq"] = t((G, Pg, H, hd), (None, None, None, None), "zeros")
            blocks["bk"] = t((G, Pg, KV, hd), (None, None, None, None), "zeros")
            blocks["bv"] = t((G, Pg, KV, hd), (None, None, None, None), "zeros")
        return base

    # ------------------------------------------------------------- cache
    @property
    def cache_heads(self) -> int:
        return self.cfg.num_kv_heads        # the true KV heads, no slots

    def cache_specs(self):
        # sequence dim sharded over the model axis; true kv heads unsharded
        spec = self.pc.spec(None, None, "batch", "ff", None, None)
        return {name: spec for name in self._kv_names()}

    # ------------------------------------------------------------- decode
    def _all_reduce(self, x, op=dist.ReduceOp.SUM):
        return TP.all_reduce(x, self.mesh.get_group(self.pc.tp_axis), op)

    def _sp_attention(self, q, k_new, v_new, kc, vc, positions, window: int):
        """Attention over this rank's sequence chunk, merged across the model
        axis, and the new token's K/V written into the chunk that holds its
        position (in place).

        q: [b, H, hd]; k/v_new: [b, KV, hd]; kc/vc: [b, s_loc, KV, hd], this
        rank's chunk; positions: [b]. Returns o [b, H * hd]."""
        cfg = self.cfg
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        ax = self.mesh.get_local_rank(self.pc.tp_axis)
        b, s_loc = kc.shape[0], kc.shape[1]
        pos = positions.long()
        local_pos = (pos % window if window > 0 else pos) - ax * s_loc
        mine = (local_pos >= 0) & (local_pos < s_loc)
        rows = torch.arange(b, device=kc.device)[mine]
        kc[rows, local_pos[mine]] = k_new[mine].to(kc.dtype)
        vc[rows, local_pos[mine]] = v_new[mine].to(vc.dtype)
        # local masked attention over my chunk
        qg = q.reshape(b, KV, H // KV, hd)
        scale = 1.0 / math.sqrt(hd)
        s = torch.einsum("bgqh,btgh->bgqt", (qg * scale).to(qg.dtype).float(),
                         kc.float())
        gidx = ax * s_loc + torch.arange(s_loc, device=kc.device)
        if window > 0:
            valid = (gidx[None, :] <= (pos % window)[:, None]) | \
                    (pos[:, None] >= window)
        else:
            valid = gidx[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, None, :], s, L.NEG_INF)
        m_loc = s.amax(dim=-1)                                  # [b, KV, qpk]
        p = torch.exp(s - m_loc[..., None])
        den = p.sum(dim=-1)
        num = torch.einsum("bgqt,btgh->bgqh", p.to(vc.dtype).float(),
                           vc.float())
        m_glob = self._all_reduce(m_loc.clone(), dist.ReduceOp.MAX)
        corr = torch.exp(m_loc - m_glob)
        merged = self._all_reduce(
            torch.cat([num * corr[..., None], (den * corr)[..., None]], -1))
        o = merged[..., :hd] / torch.clamp(merged[..., hd:], min=1e-30)
        return o.to(q.dtype).reshape(b, H * hd)

    def _shard_cols(self, x, n: int):
        """This rank's ``n`` columns of ``x`` (its slice of a dim that the
        model axis shards)."""
        m = self.mesh.get_local_rank(self.pc.tp_axis)
        return x[..., m * n:(m + 1) * n]

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """tokens/positions: [B] (the same on every rank) -> (logits, cache).
        ``params`` and ``cache`` are DTensors on ``self.mesh`` placed by
        ``param_specs()`` and ``cache_specs()``; each rank decodes its data
        shard's rows and writes its cache chunk in place. The logits are a
        DTensor ``[B, Vp]`` sharded on the batch over the DP axes."""
        cfg = self.cfg
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        B = tokens.shape[0]
        b = B // self.pc.dp
        r0 = dp_rank(self.mesh, self.pc) * b
        tokens, positions = tokens[r0:r0 + b], positions[r0:r0 + b]
        pl, cl = local_tree(params), local_tree(cache)

        # vocab-sharded embedding: each rank looks up the rows it holds
        emb = pl["embed"]
        n = emb.shape[0]
        idx = tokens.long() - self.mesh.get_local_rank(self.pc.tp_axis) * n
        hit = (idx >= 0) & (idx < n)
        x = self._all_reduce(emb[idx.clamp(0, n - 1)] * hit[:, None].to(emb.dtype))
        if self.embed_scale != 1.0:
            x = x * self.embed_scale
        x = x.to(self.dtype)

        blocks = pl["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            for p in range(self.group):
                kind = self.kinds[p]
                h = L.rmsnorm(x, pp["ln1"][p], cfg.norm_eps)
                wq, wk, wv = pp["wq"][p], pp["wk"][p], pp["wv"][p]
                h_loc = self._shard_cols(h, wq.shape[0])
                qkv = self._all_reduce(torch.cat(
                    [h_loc @ w.reshape(w.shape[0], -1) for w in (wq, wk, wv)],
                    dim=-1))
                q, k, v = qkv.split([H * hd, KV * hd, KV * hd], dim=-1)
                q, k, v = (q.reshape(b, H, hd), k.reshape(b, KV, hd),
                           v.reshape(b, KV, hd))
                if cfg.qkv_bias:
                    q = q + pp["bq"][p]
                    k = k + pp["bk"][p]
                    v = v + pp["bv"][p]
                if cfg.qk_norm:
                    q = L.rmsnorm(q, pp["q_norm"][p], cfg.norm_eps)
                    k = L.rmsnorm(k, pp["k_norm"][p], cfg.norm_eps)
                theta = LOCAL_ROPE_THETA if (kind == "local" and
                                             cfg.attn_kind == "local_global") \
                    else cfg.rope_theta
                q = L.apply_rope(q, positions[:, None], theta)
                k = L.apply_rope(k, positions[:, None], theta)
                if kind == "global":
                    i, kk, vk, win = self.full_idx[p], "k_full", "v_full", 0
                else:
                    i, kk, vk = self.win_idx[p], "k_win", "v_win"
                    win = cfg.sliding_window
                o = self._sp_attention(q, k, v, cl[kk][g, i], cl[vk][g, i],
                                       positions, win)
                wo = pp["wo"][p]
                x = x + self._all_reduce(self._shard_cols(o, wo.shape[0]) @ wo)
                h2 = L.rmsnorm(x, pp["ln2"][p], cfg.norm_eps)
                x = x + self._all_reduce(L.swiglu_mlp(
                    h2, pp["w_gate"][p], pp["w_up"][p], pp["w_down"][p], cfg.act))
        x = L.rmsnorm(x, pl["final_norm"], cfg.norm_eps)

        # vocab-sharded logits, gathered over the model axis
        w = pl["embed"].T if cfg.tie_embeddings else pl["lm_head"]
        lg = TP.gather(x @ w, self.mesh.get_group(self.pc.tp_axis)).contiguous()
        V, Vp = cfg.vocab_size, lg.shape[-1]
        if Vp > V:
            lg = lg.masked_fill(torch.arange(Vp, device=lg.device) >= V,
                                L.NEG_INF)
        spec = self.pc.spec("batch", None)
        logits = DTensor.from_local(lg, self.mesh,
                                    placements(spec, self.mesh, (B, Vp)),
                                    run_check=False, shape=torch.Size((B, Vp)),
                                    stride=(Vp, 1))
        return logits, cache

    def prefill(self, *a, **kw):
        raise NotImplementedError(
            "seq-parallel variant optimizes the decode path; prefill runs on "
            "the baseline packed layout and reshard_cache_from_packed converts")

    def train_loss(self, *a, **kw):
        raise NotImplementedError("decode-serving optimization only")


def reshard_cache_from_packed(packed_cache: Dict, model: DenseTransformer,
                              sp_model: SeqParallelDenseTransformer) -> Dict:
    """Convert a baseline packed-slot cache ([.., KVp slots, hd], duplicated kv
    heads) to the canonical layout ([.., KV, hd]), placed on ``sp_model``'s
    mesh by its ``cache_specs()`` where it has one. Pure gather: slot s of
    true kv head k holds identical values, so taking each head's first slot
    is exact."""
    lay = model.layout
    first_slot = {}
    for s, kv in enumerate(lay.dup_map):
        first_slot.setdefault(kv, s)
    out = {}
    for key, arr in packed_cache.items():
        idx = torch.as_tensor([first_slot[k] for k in range(lay.num_kv_heads)],
                              device=arr.device)
        out[key] = arr.index_select(4, idx)
    if sp_model.mesh is not None:
        out = place_tree(out, sp_model.mesh, sp_model.cache_specs())
    return out


def params_from_packed(params: Dict, model: DenseTransformer) -> Dict:
    """The baseline packed parameter tree of ``model`` in the canonical
    layout of the sequence-parallel model (the inverse of the packing, a
    pure gather, as ``reshard_cache_from_packed`` is for the cache): each Q
    head's slot, each KV head's first slot; every other leaf is shared."""
    lay, cfg = model.layout, model.cfg
    q_slot = {h: s * lay.q_per_slot + j for s, row in enumerate(lay.q_map)
              for j, h in enumerate(row) if h >= 0}
    kv_slot = {}
    for s, kv in enumerate(lay.dup_map):
        kv_slot.setdefault(kv, s)
    b = dict(params["blocks"])
    dev = b["wq"].device
    qi = torch.as_tensor([q_slot[h] for h in range(cfg.num_heads)], device=dev)
    ki = torch.as_tensor([kv_slot[k] for k in range(cfg.num_kv_heads)], device=dev)
    b["wq"] = b["wq"].flatten(3, 4).index_select(3, qi)           # [G, Pg, D, H, hd]
    b["wk"] = b["wk"].index_select(3, ki)                          # [G, Pg, D, KV, hd]
    b["wv"] = b["wv"].index_select(3, ki)
    b["wo"] = b["wo"].flatten(2, 3).index_select(2, qi).flatten(2, 3)  # [G, Pg, H*hd, D]
    if cfg.qkv_bias:
        b["bq"] = b["bq"].flatten(2, 3).index_select(2, qi)        # [G, Pg, H, hd]
        b["bk"] = b["bk"].index_select(2, ki)
        b["bv"] = b["bv"].index_select(2, ki)
    return dict(params, blocks=b)
