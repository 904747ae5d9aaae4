"""Dense decoder-only transformer (GQA, optional qk-norm / QKV-bias /
local:global sliding-window pattern), the PyTorch counterpart of
``repro/models/transformer.py::DenseTransformer``. Also serves the VLM
backbone (patch embeddings prepended through ``prefill(extra_embeds=...)``)
and is the base of ``MoETransformer``.

Layers come in *groups* of ``group`` layers, the local:global repeat pattern
(1 for uniform archs, 6 for gemma3: five sliding-window layers, then one
global). Parameters are an explicit tree of tensors (nested dicts, the same
keys and layouts as the reference's pytree, stacked per layer as
``[G, Pg, ...]``), so weights carry across from the JAX package unchanged
(``repro_torch.bridge``). The methods are functions of those parameters:
prefill and decode run under ``torch.no_grad``, ``train_loss`` is
differentiable in them (``training/train_step.py`` takes the gradients).

Caches keep the reference's layouts: global layers ``k_full``/``v_full``
``[G, n_full, B, max_len, KVs, hd]``, window layers ring buffers
``k_win``/``v_win`` ``[G, n_win, B, W, KVs, hd]`` with W = min(window,
max_len). Where the reference returns updated KV caches or pools from a jit
wrapper that donates them, the methods here write them in place and return
the same dicts.

On a mesh (``model.mesh``, a ``DeviceMesh`` whose model axis is
``pc.tp_axis``), ``prefill``, ``decode_step``, ``forward_hidden`` and
``train_loss`` given DTensor parameters placed by ``param_specs()`` run
tensor-parallel on each rank's shards, where the reference leaves the
partitioning to GSPMD: each rank takes its rows of the batch (its block on
the DP axes), its Q and KV slots of the packed layout, its ``ff`` columns and
its block of the padded vocab. Per layer the QKV projections are
column-parallel and the o-projection row-parallel (one all-reduce), and so
is the MLP (one all-reduce); the embedding is a masked lookup in the rank's
vocab rows (one all-reduce), the logits an all-gather of vocab columns, the
loss ``layers.chunked_softmax_xent`` in the region. Caches come back as DTensors
placed by ``cache_specs()`` and logits batch-sharded over the DP axes; the
gradients of the parameters are ``Partial`` over the DP axes (each rank's
rows' part), to be reduced by the optimizer. The collectives are
``tensor_parallel``'s, whose gradients are their own. At the fully sharded
layout's ``ParallelConfig`` (``launch/cells.py::fsdp_pc``: no model axis,
every mesh axis on the batch) ``train_loss`` runs each rank's rows on
whole weights, each layer group's leaves gathered inside the group's step
(``Region.gather_group``), their gradients reduce-scattered back.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (
    GQALayout, ParallelConfig, from_local, gqa_layout, local_tree)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.param_utils import (
    abstract_params, count_params, init_params, param_shardings, param_specs,
    t, unstack)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOCAL_ROPE_THETA = 10_000.0  # gemma3 uses short-rope on sliding-window layers


class DenseTransformer(TP.MeshModel, nn.Module):
    """Inference model over an explicit parameter tree."""

    # kernels the model's paged path launches on CUDA
    KERNELS = ("paged_attention", "flash_prefill")
    # the dense cache is written at a row's position, not folded into a state
    RECURRENT_CACHE = False
    # prefill attention implementation: 'block' (plain blockwise attention)
    # or 'flash' (the flash_prefill kernel on CUDA, its plain version on the
    # CPU). Instance-level; see with_prefill_attn().
    prefill_attn_impl = "block"

    def __init__(self, cfg: ModelConfig, pc: Optional[ParallelConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.pc = pc or ParallelConfig.single_device()
        self.layout: GQALayout = gqa_layout(cfg.num_heads, cfg.num_kv_heads,
                                            self.pc.tp)
        if cfg.attn_kind == "local_global":
            self.group = cfg.local_global_pattern + 1
            if cfg.num_layers % self.group:
                raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                                 f"a multiple of the {self.group}-layer group")
            self.kinds = ["local"] * cfg.local_global_pattern + ["global"]
        elif cfg.attn_kind == "swa":
            self.group, self.kinds = 1, ["local"]
        elif cfg.attn_kind == "full":
            self.group, self.kinds = 1, ["global"]
        else:
            raise ValueError(f"{cfg.name}: attn_kind {cfg.attn_kind!r} is not "
                             f"a transformer's")
        self.n_groups = cfg.num_layers // self.group
        self.full_idx = {p: i for i, p in enumerate(
            [p for p in range(self.group) if self.kinds[p] == "global"])}
        self.win_idx = {p: i for i, p in enumerate(
            [p for p in range(self.group) if self.kinds[p] == "local"])}
        self.n_full = len(self.full_idx)
        self.n_win = len(self.win_idx)
        self.embed_scale = math.sqrt(cfg.d_model) if "gemma" in cfg.name else 1.0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ---------------------------------------------------------------- params
    def templates(self):
        cfg, lay = self.cfg, self.layout
        G, Pg, D = self.n_groups, self.group, cfg.d_model
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

        # each draws the first n of the G groups (init_params' by_layer: 1)
        def init_wq(gen, n):  # packed layout: zero weights on pad Q slots (exact)
            w = randn(gen, (n, Pg, D, KVs, Qp, hd)).div_(math.sqrt(D))
            return w.mul_(qmask(gen)[None, None, None, :, :, None])

        def init_wo(gen, n):
            w = randn(gen, (n, Pg, KVs, Qp, hd, D)).div_(
                math.sqrt(lay.num_heads * hd))
            return w.mul_(qmask(gen)[None, None, :, :, None, None])

        def init_kv(gen, n):  # canonical KV heads, then duplicate into slots
            w = randn(gen, (n, Pg, D, KV, hd)).div_(math.sqrt(D))
            return w.index_select(3, dup.to(gen.device))

        blocks: Dict[str, Any] = {
            "ln1": t((G, Pg, D), (None, None, None), "zeros"),
            "ln2": t((G, Pg, D), (None, None, None), "zeros"),
            "wq": t((G, Pg, D, KVs, Qp, hd), (None, None, None, "kv_heads", None, None),
                    custom=init_wq),
            "wk": t((G, Pg, D, KVs, hd), (None, None, None, "kv_heads", None),
                    custom=init_kv),
            "wv": t((G, Pg, D, KVs, hd), (None, None, None, "kv_heads", None),
                    custom=init_kv),
            "wo": t((G, Pg, KVs, Qp, hd, D), (None, None, "kv_heads", None, None, None),
                    custom=init_wo),
        }
        if cfg.qkv_bias:
            blocks["bq"] = t((G, Pg, KVs, Qp, hd), (None, None, "kv_heads", None, None),
                             "zeros")
            blocks["bk"] = t((G, Pg, KVs, hd), (None, None, "kv_heads", None), "zeros")
            blocks["bv"] = t((G, Pg, KVs, hd), (None, None, "kv_heads", None), "zeros")
        if cfg.qk_norm:
            blocks["q_norm"] = t((G, Pg, hd), (None, None, None), "zeros")
            blocks["k_norm"] = t((G, Pg, hd), (None, None, None), "zeros")
        blocks.update(self._mlp_templates())
        Vp = cfg.padded_vocab(self.pc.tp)
        tree = {
            "embed": t((Vp, D), ("vocab", None), fan_in=D),
            "blocks": blocks,
            "final_norm": t((D,), (None,), "zeros"),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = t((D, Vp), (None, "vocab"), fan_in=D)
        return tree

    def _mlp_templates(self):
        cfg = self.cfg
        G, Pg, D, F = self.n_groups, self.group, cfg.d_model, cfg.d_ff
        return {
            "w_gate": t((G, Pg, D, F), (None, None, None, "ff"), fan_in=D),
            "w_up": t((G, Pg, D, F), (None, None, None, "ff"), fan_in=D),
            "w_down": t((G, Pg, F, D), (None, None, "ff", None), fan_in=F),
        }

    def abstract_params(self):
        return abstract_params(self.templates(), self.dtype)

    def init_params(self, generator: torch.Generator, by_layer: bool = False):
        """Random parameters on ``generator.device`` in the config's dtype
        (``by_layer``: drawn one layer group at a time, see
        ``param_utils.init_params``)."""
        return init_params(self.templates(), generator, self.dtype, by_layer)

    def param_specs(self):
        return param_specs(self.templates(), self.pc)

    def param_shardings(self, mesh):
        return param_shardings(self.templates(), self.pc, mesh)

    def param_count(self) -> int:
        return count_params(self.templates())

    # ---------------------------------------------------------------- cache
    def _window(self, max_len: int) -> int:
        return min(self.cfg.sliding_window or max_len, max_len)

    @property
    def cache_heads(self) -> int:
        """KV heads of a cache row: the packed layout's slots."""
        return self.layout.kv_slots

    def init_cache(self, batch: int, max_len: int, device=None):
        """Dense KV cache: ``k_full``/``v_full [G, n_full, batch, max_len,
        KVs, hd]`` for global layers, ring buffers ``k_win``/``v_win
        [G, n_win, batch, W, KVs, hd]`` for window layers."""
        tail = (batch, max_len, self.cache_heads, self.cfg.head_dim)
        out = {}
        if self.n_full:
            shp = (self.n_groups, self.n_full) + tail
            out["k_full"] = torch.zeros(shp, dtype=self.dtype, device=device)
            out["v_full"] = torch.zeros(shp, dtype=self.dtype, device=device)
        if self.n_win:
            shp = (self.n_groups, self.n_win, batch, self._window(max_len)) + tail[2:]
            out["k_win"] = torch.zeros(shp, dtype=self.dtype, device=device)
            out["v_win"] = torch.zeros(shp, dtype=self.dtype, device=device)
        return out

    def _kv_names(self):
        return (("k_full", "v_full") if self.n_full else ()) + (
            ("k_win", "v_win") if self.n_win else ())

    def cache_specs(self):
        spec = self.pc.spec(None, None, "batch", None, "kv_heads", None)
        return {name: spec for name in self._kv_names()}

    def cache_slot_axes(self) -> Dict[str, int]:
        """Axis of each dense-cache entry that indexes the sequence (slot)."""
        return {name: 2 for name in self._kv_names()}

    def cache_struct(self, batch: int, max_len: int):
        """Shapes and dtypes of ``init_cache``'s tree (``meta`` tensors)."""
        return self.init_cache(batch, max_len, device="meta")

    @property
    def scan_trip_count(self) -> int:
        return self.n_groups

    @property
    def layers_per_scan_step(self) -> int:
        return self.group

    # ---------------------------------------------------------------- paged cache
    def supports_paged(self) -> bool:
        """Whether the block-paged KV path covers this arch: every layer must
        be full (global) attention; ring-buffer window layers have no paged
        layout, as in the reference."""
        return self.n_win == 0

    def init_paged_pools(self, num_blocks: int, block_size: int, device=None):
        """Block-paged KV pools: one ``[num_blocks, block_size, KVs, hd]`` K
        and V pool per layer, stacked as ``[G, n_full, num_blocks, ...]``.
        Block id ``num_blocks - 1`` is conventionally the executor's scratch
        block."""
        if not self.supports_paged():
            raise NotImplementedError(
                f"{self.cfg.name}: paged KV supports full-attention archs only "
                f"(this arch has {self.n_win} window layer(s) per group)")
        shp = (self.n_groups, self.n_full, num_blocks, block_size,
               self.layout.kv_slots, self.cfg.head_dim)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=device),
                "v": torch.zeros(shp, dtype=self.dtype, device=device)}

    def scatter_prefill_pools(self, pools, caches, block_tables):
        """Write a padded, batched prefill's dense caches (k/v_full
        ``[G, n_full, B, L, KVs, hd]``, L a multiple of block_size) into the
        pools in place, block ``j`` of row ``b`` to ``block_tables[b, j]``. Pad
        rows and pad blocks point at the scratch block: duplicate indices land
        only there, whose contents never matter."""
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
        tables = block_tables.long()
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            for p in range(self.group):
                h = L.rmsnorm(x, pp["ln1"][p], cfg.norm_eps)
                q, k, v = self._qkv(pp, p, h, positions, "global")
                i = self.full_idx[p]
                pk, pv = pools["k"][g, i], pools["v"][g, i]
                pk[bids, offs] = k.to(pk.dtype)
                pv[bids, offs] = v.to(pv.dtype)
                if attn_impl == "ref":
                    kg = pk[tables]                      # [B, NB, bs, KVs, hd]
                    vg = pv[tables]
                    Bq, NB, bsz, KVs, hd = kg.shape
                    o = L.decode_attention(q, kg.reshape(Bq, NB * bsz, KVs, hd),
                                           vg.reshape(Bq, NB * bsz, KVs, hd),
                                           positions)
                else:
                    o = ops.paged_attention(q.contiguous(), pk, pv, block_tables,
                                            context_lens)
                x = x + self._attn_out(o, pp["wo"][p])
                h = L.rmsnorm(x, pp["ln2"][p], cfg.norm_eps)
                mlp, _ = self._mlp(pp, p, h)
                x = x + mlp
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, x), pools

    # ------------------------------------------------------------- building blocks
    def _qkv(self, pp, p: int, x, positions, kind: str):
        """x: [B, (S,) D] -> q [..., G, Qp, hd], k/v [..., G, hd], rope applied
        (``LOCAL_ROPE_THETA`` on the window layers of a local:global arch)."""
        cfg = self.cfg
        wq, wk, wv = pp["wq"][p], pp["wk"][p], pp["wv"][p]
        x = self._region.enter(x)
        D = x.shape[-1]
        q = (x @ wq.reshape(D, -1)).reshape(*x.shape[:-1], *wq.shape[1:])
        k = (x @ wk.reshape(D, -1)).reshape(*x.shape[:-1], *wk.shape[1:])
        v = (x @ wv.reshape(D, -1)).reshape(*x.shape[:-1], *wv.shape[1:])
        if cfg.qkv_bias:
            q = q + pp["bq"][p]
            k = k + pp["bk"][p]
            v = v + pp["bv"][p]
        if cfg.qk_norm:   # replicated weights in the region: gradients summed
            q = L.rmsnorm(q, self._region.enter(pp["q_norm"][p]), cfg.norm_eps)
            k = L.rmsnorm(k, self._region.enter(pp["k_norm"][p]), cfg.norm_eps)
        theta = LOCAL_ROPE_THETA if (kind == "local"
                                     and cfg.attn_kind == "local_global") \
            else cfg.rope_theta
        if x.ndim == 3:  # [B, S, D]
            q = L.apply_rope(q, positions[:, :, None, None], theta)
            k = L.apply_rope(k, positions[:, :, None], theta)
        else:            # [B, D] decode
            q = L.apply_rope(q, positions[:, None, None], theta)
            k = L.apply_rope(k, positions[:, None], theta)
        return q, k, v

    def _attn_out(self, o, wo):
        """o [..., G, Qp, hd] @ wo [G, Qp, hd, D] -> [..., D] (row-parallel
        on a mesh: the ranks' partial sums all-reduced)."""
        lead = o.shape[:-3]
        return self._region.reduce(o.reshape(*lead, -1)
                                   @ wo.reshape(-1, wo.shape[-1]))

    def _mlp(self, pp, p: int, x):
        """Layer ``p`` of the group's MLP -> (out, aux loss)."""
        out = L.swiglu_mlp(self._region.enter(x), pp["w_gate"][p],
                           pp["w_up"][p], pp["w_down"][p], self.cfg.act)
        return (self._region.reduce(out),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def _mixer_seq(self, pp, p: int, x, positions, seq_lens, kind: str):
        """Sequence-mode attention of layer ``p``. Returns (out, (k, v))."""
        q, k, v = self._qkv(pp, p, x, positions, kind)
        window = self.cfg.sliding_window if kind == "local" else 0
        if self.prefill_attn_impl == "flash":
            # causal masking alone suffices for ragged batches: rows past a
            # sequence's length attend only pad keys in their own causal past
            # and are never read (the last-token gather uses seq_lens).
            # Layout swap [B,S,G,Qp,hd] <-> [B,G,S,R,hd] as strided views.
            o = ops.flash_prefill(q.movedim(1, 2), k.movedim(1, 2),
                                  v.movedim(1, 2), causal=True, window=window)
            o = o.movedim(2, 1)
        else:
            o = L.block_attention(q, k, v, causal=True, window=window,
                                  seq_lens=seq_lens)
        return self._attn_out(o, pp["wo"][p]), (k, v)

    def with_prefill_attn(self, impl: str) -> "DenseTransformer":
        """A sibling model instance (same config, same parameter tree) whose
        prefill attention runs via ``impl`` ('block' | 'flash')."""
        if impl not in ("block", "flash"):
            raise ValueError(f"unknown prefill attention impl {impl!r}")
        m = type(self)(self.cfg, self.pc)
        m.prefill_attn_impl = impl
        m.mesh = self.mesh
        return m

    def _attn_decode_inplace(self, pp, p: int, x, positions, kind: str,
                             cache, g: int):
        """Decode attention of layer ``(g, p)`` with in-place KV writes into
        the stacked cache (a ring buffer on window layers)."""
        q, k, v = self._qkv(pp, p, x, positions, kind)
        window = self.cfg.sliding_window if kind == "local" else 0
        if kind == "global":
            i, kk, vk = self.full_idx[p], "k_full", "v_full"
        else:
            i, kk, vk = self.win_idx[p], "k_win", "v_win"
        L.cache_write_full(cache[kk], g, i, k, positions, window)
        L.cache_write_full(cache[vk], g, i, v, positions, window)
        o = L.decode_attention(q, cache[kk][g, i], cache[vk][g, i], positions,
                               window=window)
        return self._attn_out(o, pp["wo"][p])

    # ------------------------------------------------------------- forward (seq mode)
    def _layer_seq(self, pp, p: int, x, positions, seq_lens, kind: str):
        """Layer ``p`` of a group in sequence mode -> (x, aux loss, (k, v),
        extra cache entries of this layer). Hybrid layers override it."""
        cfg = self.cfg
        h = L.rmsnorm(x, pp["ln1"][p], cfg.norm_eps)
        attn, kv = self._mixer_seq(pp, p, h, positions, seq_lens, kind)
        x = x + attn
        h = L.rmsnorm(x, pp["ln2"][p], cfg.norm_eps)
        mlp, a = self._mlp(pp, p, h)
        return x + mlp, a, kv, {}

    def _group_seq(self, pp, x, aux, positions, seq_lens, collect: bool,
                   max_len: int):
        """One group of layers -> (x, aux, this group's caches): k/v_full
        ``[n_full, B, max_len, KVs, hd]``, the rings k/v_win ``[n_win, B, W,
        KVs, hd]``, and each extra entry of the group's one layer."""
        pp = self._region.gather_group("blocks", pp)
        S = x.shape[1]
        W = self._window(max_len)
        full, win, extra = ([], []), ([], []), {}
        for p in range(self.group):
            kind = self.kinds[p]
            x, a, (k, v), more = self._layer_seq(pp, p, x, positions, seq_lens,
                                                 kind)
            aux = aux + a
            if not collect:
                continue
            extra.update(more)          # hybrid layers come in groups of one
            if kind == "global":
                pad = max_len - S
                if pad:
                    k = F.pad(k, (0, 0, 0, 0, 0, pad))
                    v = F.pad(v, (0, 0, 0, 0, 0, pad))
                full[0].append(k)
                full[1].append(v)
            else:
                win[0].append(L.ring_from_sequence(k, W, seq_lens))
                win[1].append(L.ring_from_sequence(v, W, seq_lens))
        caches = dict(extra)
        if full[0]:
            caches["k_full"], caches["v_full"] = map(torch.stack, full)
        if win[0]:
            caches["k_win"], caches["v_win"] = map(torch.stack, win)
        return x, aux, caches

    def forward_hidden(self, params, embeds, positions, seq_lens=None, *,
                       collect_cache=False, max_len: int = 0, remat=False):
        """embeds: [B, S, D] -> (hidden [B, S, D], aux, cache | {}), caches
        stacked over groups. ``remat`` recomputes each group's activations
        in the backward pass (``torch.utils.checkpoint``), as the reference
        wraps its layer scan's body in ``jax.checkpoint``. On a mesh (DTensor
        params) each rank runs its rows of ``embeds``, ``positions`` and
        ``seq_lens`` and gets back its rows' hidden states and caches."""
        if self._sharded(params):
            with self._tp_region():
                return self.forward_hidden(
                    self._local_params(params), self._rows(embeds),
                    self._rows(positions), self._rows(seq_lens),
                    collect_cache=collect_cache, max_len=max_len, remat=remat)
        max_len = max_len or embeds.shape[1]
        x = embeds
        aux = torch.zeros((), dtype=torch.float32, device=embeds.device)
        per_group = []
        region = self._region

        def group_seq(*args):   # the recomputation runs in the same region
            with self._in_region(region):
                return self._group_seq(*args)

        for pp in unstack(params["blocks"]):
            args = (pp, x, aux, positions, seq_lens, collect_cache, max_len)
            if remat:
                # no RNG state kept: the loss draws no random numbers, and
                # reading the CUDA generator's state fails under capture
                x, aux, caches = checkpoint(group_seq, *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                x, aux, caches = self._group_seq(*args)
            per_group.append(caches)
        if not collect_cache:
            caches = {}
        elif per_group:
            caches = {name: torch.stack([c[name] for c in per_group])
                      for name in per_group[0]}
        else:             # no layer (a roofline's 0-layer variant)
            caches = self.init_cache(x.shape[0], max_len, device=x.device)
        x = L.rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return x, aux, caches

    def embed_tokens(self, params, tokens):
        e = self._region.lookup(params["embed"], tokens)
        if self.embed_scale != 1.0:
            e = e * self.embed_scale
        return e.to(self.dtype)

    def logits(self, params, hidden):
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return L.vocab_logits(hidden, w, self.cfg.vocab_size, self._region)

    # ------------------------------------------------------------- public steps
    def train_loss(self, params, batch, *, remat=True):
        """batch: {'tokens': [B, S_text], 'labels': [B, S_total] (-1 pad),
        'extra_embeds': optional [B, P, D] patch embeddings, prepended} ->
        (loss, metrics), differentiable in ``params``. Attention is the plain
        blockwise path whatever ``prefill_attn_impl`` says: the kernels are
        forward-only, as the reference's Pallas kernels have no VJP. On a
        mesh each rank takes its rows of ``batch`` and the loss is the whole
        batch's, on every rank."""
        if self.prefill_attn_impl != "block":
            return self.with_prefill_attn("block").train_loss(
                params, batch, remat=remat)
        if self._sharded(params):
            with self._tp_region():
                return self.train_loss(
                    self._local_params(params),
                    {k: self._rows(v) for k, v in batch.items()}, remat=remat)
        embeds = self.embed_tokens(params, batch["tokens"])
        if batch.get("extra_embeds") is not None:
            embeds = torch.cat([batch["extra_embeds"].to(self.dtype), embeds],
                               dim=1)
        B, S = embeds.shape[:2]
        positions = L.causal_positions(S, B, embeds.device)
        hidden, aux, _ = self.forward_hidden(params, embeds, positions,
                                             remat=remat)
        w_vocab = (params["embed"].T if self.cfg.tie_embeddings
                   else params["lm_head"])
        region = self._region
        total, count = L.chunked_softmax_xent(
            hidden, w_vocab, batch["labels"], vocab_valid=self.cfg.vocab_size,
            region=region)
        if region.dp_groups:
            total, count = region.reduce_dp(total), region.reduce_dp(count)
            if self._aux_weight():
                # the data shards' mean: the reference's gradient (its
                # local-EP aux is each shard's own value; ROADMAP.md §3)
                aux = region.reduce_dp(aux) / self.pc.dp
        xent = total / torch.clamp(count, min=1.0)
        loss = xent + self._aux_weight() * aux / max(1, self.cfg.num_layers)
        return loss, {"xent": xent, "aux": aux}

    def _aux_weight(self) -> float:
        return 0.0

    @torch.no_grad()
    def prefill(self, params, tokens, *, seq_lens=None, max_len: int = 0,
                extra_embeds=None):
        """tokens [B, S] -> (last-token logits [B, V], cache). ``extra_embeds``
        [B, P, D] are patch embeddings prepended to the tokens' (the VLM stub
        frontend); ``seq_lens`` and ``max_len`` then count them too. On a
        mesh (DTensor params) the logits are a DTensor sharded on the batch
        and the cache DTensors placed by ``cache_specs()``."""
        if self._sharded(params):
            with self._tp_region():
                lg, caches = self.prefill(
                    self._local_params(params), self._rows(tokens),
                    seq_lens=self._rows(seq_lens), max_len=max_len,
                    extra_embeds=self._rows(extra_embeds))
            specs = self.cache_specs()
            return self._by_batch(lg), {k: from_local(v, self.mesh, specs[k])
                                        for k, v in caches.items()}
        B = tokens.shape[0]
        embeds = self.embed_tokens(params, tokens)
        if extra_embeds is not None:
            embeds = torch.cat([extra_embeds.to(self.dtype), embeds], dim=1)
        S = embeds.shape[1]
        positions = L.causal_positions(S, B, tokens.device)
        hidden, _, caches = self.forward_hidden(
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
        layer's KV write goes into ``cache`` in place. On a mesh (DTensor
        params and cache) each rank steps its rows and writes its cache
        shard."""
        if self._sharded(params):
            with self._tp_region():
                lg, _ = self.decode_step(
                    self._local_params(params), local_tree(cache),
                    self._rows(tokens), self._rows(positions))
            return self._by_batch(lg), cache
        x = self.embed_tokens(params, tokens)
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            for p in range(self.group):
                x = self._layer_decode(pp, p, x, positions, cache, g)
        x = L.rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return self.logits(params, x), cache

    def _layer_decode(self, pp, p: int, x, positions, cache, g: int):
        """Layer ``(g, p)`` of one decode step, its cache writes in place.
        Hybrid layers override it."""
        cfg = self.cfg
        h = L.rmsnorm(x, pp["ln1"][p], cfg.norm_eps)
        x = x + self._attn_decode_inplace(pp, p, h, positions, self.kinds[p],
                                          cache, g)
        h = L.rmsnorm(x, pp["ln2"][p], cfg.norm_eps)
        mlp, _ = self._mlp(pp, p, h)
        return x + mlp

    def with_layers(self, num_layers: int) -> "DenseTransformer":
        """Same arch with a different layer count (a multiple of the group);
        the prefill attention impl carries over."""
        m = type(self)(self.cfg.replace(num_layers=num_layers), self.pc)
        m.prefill_attn_impl = self.prefill_attn_impl
        m.mesh = self.mesh
        return m
