"""Dense decoder-only transformer (GQA, optional qk-norm / QKV-bias), the
PyTorch counterpart of ``repro/models/transformer.py::DenseTransformer``.

Parameters are an explicit tree of tensors (nested dicts, the same keys and
layouts as the reference's pytree, stacked per layer as ``[G, Pg, ...]``), so
weights carry across from the JAX package unchanged (``repro_torch.bridge``).
The methods are functions of those parameters, run under ``torch.no_grad``.

Where the reference returns updated KV caches or pools from a jit wrapper that
donates them, the methods here write them in place and return the same dicts.

Covered: uniform full-attention archs (``attn_kind='full'``). The
local_global / sliding-window layers and ``extra_embeds`` are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import GQALayout, gqa_layout
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.param_utils import count_params, init_params, t

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class DenseTransformer(nn.Module):
    """Inference model over an explicit parameter tree."""

    # prefill attention implementation: 'block' (plain blockwise attention)
    # or 'flash' (the flash_prefill kernel on CUDA, its plain version on the
    # CPU). Instance-level; see with_prefill_attn().
    prefill_attn_impl = "block"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.attn_kind != "full":
            raise NotImplementedError(
                f"{cfg.name}: attn_kind {cfg.attn_kind!r} is not ported to "
                f"repro_torch yet (full attention only)")
        self.cfg = cfg
        self.layout: GQALayout = gqa_layout(cfg.num_heads, cfg.num_kv_heads, 1)
        self.group = 1
        self.n_groups = cfg.num_layers

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ---------------------------------------------------------------- params
    def templates(self):
        cfg, lay = self.cfg, self.layout
        G, Pg, D, F = self.n_groups, self.group, cfg.d_model, cfg.d_ff
        KVs, Qp, hd = lay.kv_slots, lay.q_per_slot, cfg.head_dim
        KV = lay.num_kv_heads
        qmask_np = lay.q_array() >= 0                    # [KVs, Qp] pad-slot mask
        dup = torch.as_tensor(lay.dup_array(), dtype=torch.long)

        def randn(gen, shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)

        def qmask(gen):
            return torch.as_tensor(qmask_np, dtype=torch.float32,
                                   device=gen.device)

        def init_wq(gen):  # packed layout: zero weights on pad Q slots (exact)
            w = randn(gen, (G, Pg, D, KVs, Qp, hd)) / math.sqrt(D)
            return w * qmask(gen)[None, None, None, :, :, None]

        def init_wo(gen):
            w = randn(gen, (G, Pg, KVs, Qp, hd, D)) / math.sqrt(lay.num_heads * hd)
            return w * qmask(gen)[None, None, :, :, None, None]

        def init_kv(gen):  # canonical KV heads, then duplicate into slots
            w = randn(gen, (G, Pg, D, KV, hd)) / math.sqrt(D)
            return w.index_select(3, dup.to(gen.device))

        blocks: Dict[str, Any] = {
            "ln1": t((G, Pg, D), "zeros"),
            "ln2": t((G, Pg, D), "zeros"),
            "wq": t((G, Pg, D, KVs, Qp, hd), custom=init_wq),
            "wk": t((G, Pg, D, KVs, hd), custom=init_kv),
            "wv": t((G, Pg, D, KVs, hd), custom=init_kv),
            "wo": t((G, Pg, KVs, Qp, hd, D), custom=init_wo),
        }
        if cfg.qkv_bias:
            blocks["bq"] = t((G, Pg, KVs, Qp, hd), "zeros")
            blocks["bk"] = t((G, Pg, KVs, hd), "zeros")
            blocks["bv"] = t((G, Pg, KVs, hd), "zeros")
        if cfg.qk_norm:
            blocks["q_norm"] = t((G, Pg, hd), "zeros")
            blocks["k_norm"] = t((G, Pg, hd), "zeros")
        blocks["w_gate"] = t((G, Pg, D, F), fan_in=D)
        blocks["w_up"] = t((G, Pg, D, F), fan_in=D)
        blocks["w_down"] = t((G, Pg, F, D), fan_in=F)
        tree = {
            "embed": t((cfg.vocab_size, D), fan_in=D),
            "blocks": blocks,
            "final_norm": t((D,), "zeros"),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = t((D, cfg.vocab_size), fan_in=D)
        return tree

    def init_params(self, generator: torch.Generator):
        """Random parameters on ``generator.device`` in the config's dtype."""
        return init_params(self.templates(), generator, self.dtype)

    def param_count(self) -> int:
        return count_params(self.templates())

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device=None):
        """Dense KV cache ``{"k_full", "v_full"}``, each
        ``[G, 1, batch, max_len, KVs, hd]``."""
        shp = (self.n_groups, 1, batch, max_len, self.layout.kv_slots,
               self.cfg.head_dim)
        return {"k_full": torch.zeros(shp, dtype=self.dtype, device=device),
                "v_full": torch.zeros(shp, dtype=self.dtype, device=device)}

    # ---------------------------------------------------------------- paged cache
    def supports_paged(self) -> bool:
        """Every layer of the ported archs is full attention."""
        return True

    def init_paged_pools(self, num_blocks: int, block_size: int, device=None):
        """Block-paged KV pools: one ``[num_blocks, block_size, KVs, hd]`` K
        and V pool per layer, stacked as ``[G, 1, num_blocks, ...]``. Block id
        ``num_blocks - 1`` is conventionally the executor's scratch block."""
        shp = (self.n_groups, 1, num_blocks, block_size,
               self.layout.kv_slots, self.cfg.head_dim)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=device),
                "v": torch.zeros(shp, dtype=self.dtype, device=device)}

    def scatter_prefill_pools(self, pools, caches, block_tables):
        """Write a padded, batched prefill's dense caches (k/v_full
        ``[G, 1, B, L, KVs, hd]``, L a multiple of block_size) into the pools
        in place, block ``j`` of row ``b`` to ``block_tables[b, j]``. Pad rows
        and pad blocks point at the scratch block: duplicate indices land only
        there, whose contents never matter."""
        bs = pools["k"].shape[3]
        idx = block_tables.long()
        for name in ("k", "v"):
            c = caches[f"{name}_full"]
            G, NF, B, Lc, KVs, hd = c.shape
            c = c.reshape(G, NF, B, Lc // bs, bs, KVs, hd)
            pools[name][:, :, idx] = c.to(pools[name].dtype)
        return pools

    @torch.no_grad()
    def decode_step_paged(self, params, pools, tokens, positions,
                          block_tables, context_lens, *,
                          attn_impl: str = "ref"):
        """One decode step against the block-paged KV pools.

        tokens/positions: [B] int32; block_tables: [B, max_blocks] int32;
        context_lens: [B] int32 (== positions + 1 for live rows). Each layer
        writes the new token's K/V into its pool in place at
        ``(block_tables[b, pos // bs], pos % bs)``, then attends through the
        ``paged_attention`` kernel (``attn_impl='kernel'``; its plain version
        on CPU tensors) or by gathering the pages and running the exact dense
        decode recipe (``'ref'``), which keeps paged and dense decode
        bit-identical. Returns (logits, pools).
        """
        if attn_impl not in ("ref", "kernel"):
            raise ValueError(f"unknown paged attention impl {attn_impl!r}")
        cfg = self.cfg
        bs = pools["k"].shape[3]
        B = tokens.shape[0]
        x = self.embed_tokens(params, tokens)
        rows = torch.arange(B, device=tokens.device)
        pos = positions.long()
        bids = block_tables[rows, pos // bs].long()
        offs = pos % bs
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            h = L.rmsnorm(x, pp["ln1"][0], cfg.norm_eps)
            q, k, v = self._qkv(pp, h, positions)
            pk, pv = pools["k"][g, 0], pools["v"][g, 0]
            pk[bids, offs] = k.to(pk.dtype)
            pv[bids, offs] = v.to(pv.dtype)
            if attn_impl == "ref":
                kg = pk[block_tables.long()]             # [B, NB, bs, KVs, hd]
                vg = pv[block_tables.long()]
                Bq, NB, bsz, KVs, hd = kg.shape
                o = L.decode_attention(q, kg.reshape(Bq, NB * bsz, KVs, hd),
                                       vg.reshape(Bq, NB * bsz, KVs, hd),
                                       positions)
            else:
                o = ops.paged_attention(q.contiguous(), pk, pv, block_tables,
                                        context_lens)
            x = x + self._attn_out(o, pp["wo"][0])
            h = L.rmsnorm(x, pp["ln2"][0], cfg.norm_eps)
            x = x + self._mlp(pp, h)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, x), pools

    # ------------------------------------------------------------- building blocks
    def _qkv(self, pp, x, positions):
        """x: [B, (S,) D] -> q [..., G, Qp, hd], k/v [..., G, hd], rope applied."""
        cfg = self.cfg
        wq, wk, wv = pp["wq"][0], pp["wk"][0], pp["wv"][0]
        D = x.shape[-1]
        q = (x @ wq.reshape(D, -1)).reshape(*x.shape[:-1], *wq.shape[1:])
        k = (x @ wk.reshape(D, -1)).reshape(*x.shape[:-1], *wk.shape[1:])
        v = (x @ wv.reshape(D, -1)).reshape(*x.shape[:-1], *wv.shape[1:])
        if cfg.qkv_bias:
            q = q + pp["bq"][0]
            k = k + pp["bk"][0]
            v = v + pp["bv"][0]
        if cfg.qk_norm:
            q = L.rmsnorm(q, pp["q_norm"][0], cfg.norm_eps)
            k = L.rmsnorm(k, pp["k_norm"][0], cfg.norm_eps)
        if x.ndim == 3:  # [B, S, D]
            q = L.apply_rope(q, positions[:, :, None, None], cfg.rope_theta)
            k = L.apply_rope(k, positions[:, :, None], cfg.rope_theta)
        else:            # [B, D] decode
            q = L.apply_rope(q, positions[:, None, None], cfg.rope_theta)
            k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
        return q, k, v

    @staticmethod
    def _attn_out(o, wo):
        """o [..., G, Qp, hd] @ wo [G, Qp, hd, D] -> [..., D]."""
        lead = o.shape[:-3]
        return o.reshape(*lead, -1) @ wo.reshape(-1, wo.shape[-1])

    def _mlp(self, pp, x):
        return L.swiglu_mlp(x, pp["w_gate"][0], pp["w_up"][0], pp["w_down"][0],
                            self.cfg.act)

    def _attn_seq(self, pp, x, positions, seq_lens):
        """Sequence-mode attention. Returns (out, (k, v))."""
        q, k, v = self._qkv(pp, x, positions)
        if self.prefill_attn_impl == "flash":
            # causal masking alone suffices for ragged batches: rows past a
            # sequence's length attend only pad keys in their own causal past
            # and are never read (the last-token gather uses seq_lens).
            # Layout swap [B,S,G,Qp,hd] <-> [B,G,S,R,hd] as strided views.
            o = ops.flash_prefill(q.movedim(1, 2), k.movedim(1, 2),
                                  v.movedim(1, 2), causal=True)
            o = o.movedim(2, 1)
        else:
            o = L.block_attention(q, k, v, causal=True, seq_lens=seq_lens)
        return self._attn_out(o, pp["wo"][0]), (k, v)

    def with_prefill_attn(self, impl: str) -> "DenseTransformer":
        """A sibling model instance (same config, same parameter tree) whose
        prefill attention runs via ``impl`` ('block' | 'flash')."""
        if impl not in ("block", "flash"):
            raise ValueError(f"unknown prefill attention impl {impl!r}")
        m = type(self)(self.cfg)
        m.prefill_attn_impl = impl
        return m

    # ------------------------------------------------------------- forward (seq mode)
    def forward_hidden(self, params, embeds, positions, seq_lens=None, *,
                       collect_cache=False, max_len: int = 0):
        """embeds: [B, S, D] -> (hidden [B, S, D], cache | {})."""
        cfg = self.cfg
        x = embeds
        S = embeds.shape[1]
        max_len = max_len or S
        kf, vf = [], []
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            h = L.rmsnorm(x, pp["ln1"][0], cfg.norm_eps)
            attn, (k, v) = self._attn_seq(pp, h, positions, seq_lens)
            x = x + attn
            h = L.rmsnorm(x, pp["ln2"][0], cfg.norm_eps)
            x = x + self._mlp(pp, h)
            if collect_cache:
                pad = max_len - S
                if pad:
                    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                kf.append(k)
                vf.append(v)
        caches = {}
        if collect_cache:
            caches["k_full"] = torch.stack(kf)[:, None]
            caches["v_full"] = torch.stack(vf)[:, None]
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, caches

    def embed_tokens(self, params, tokens):
        return params["embed"][tokens.long()].to(self.dtype)

    def logits(self, params, hidden):
        if self.cfg.tie_embeddings:
            return hidden @ params["embed"].T
        return hidden @ params["lm_head"]

    # ------------------------------------------------------------- public steps
    @torch.no_grad()
    def prefill(self, params, tokens, *, seq_lens=None, max_len: int = 0):
        """tokens [B, S] -> (last-token logits [B, V], cache with k/v_full
        ``[G, 1, B, max_len, KVs, hd]``)."""
        B, S = tokens.shape
        embeds = self.embed_tokens(params, tokens)
        positions = L.causal_positions(S, B, tokens.device)
        hidden, caches = self.forward_hidden(
            params, embeds, positions, seq_lens, collect_cache=True,
            max_len=max_len or S)
        if seq_lens is not None:
            idx = (seq_lens.long() - 1)[:, None, None].expand(B, 1, hidden.shape[-1])
            last = torch.gather(hidden, 1, idx)[:, 0]
        else:
            last = hidden[:, -1]
        return self.logits(params, last), caches

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """tokens: [B] int32, positions: [B] -> (logits [B, V], cache); each
        layer's KV write goes into ``cache`` in place."""
        cfg = self.cfg
        x = self.embed_tokens(params, tokens)
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            h = L.rmsnorm(x, pp["ln1"][0], cfg.norm_eps)
            q, k, v = self._qkv(pp, h, positions)
            L.cache_write_full(cache["k_full"], g, 0, k, positions)
            L.cache_write_full(cache["v_full"], g, 0, v, positions)
            o = L.decode_attention(q, cache["k_full"][g, 0],
                                   cache["v_full"][g, 0], positions)
            x = x + self._attn_out(o, pp["wo"][0])
            h = L.rmsnorm(x, pp["ln2"][0], cfg.norm_eps)
            x = x + self._mlp(pp, h)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, x), cache
