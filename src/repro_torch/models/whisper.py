"""Whisper-style encoder-decoder backbone, the PyTorch counterpart of
``repro/models/whisper.py::WhisperModel``. The conv/mel frontend is a stub,
as in the reference: the model takes precomputed frame embeddings
``[B, S, D]`` (sinusoidal positions are added here). Decoder: causal
self-attention (cached) plus cross-attention against each layer's encoder
K/V, computed once at prefill, and learned positions ``pos_dec``.

Parameters keep the reference's tree (``enc`` / ``dec`` stacked per layer,
the packed GQA attention layout of ``DenseTransformer``), so weights carry
across through ``repro_torch.bridge``. The cache keeps the reference's
layout: ``k_self``/``v_self [Ld, B, T, KVs, hd]`` with T = max_target_len,
``k_cross``/``v_cross [Ld, B, S, KVs, hd]`` and ``frame_lens [B]``.

There is no engine path, as in the reference: the executors call
``prefill`` without frames, and ``prefill`` refuses to run on none.

On a mesh (``model.mesh``; ``TP.MeshModel``) ``prefill``, ``decode_step``
and ``train_loss`` given DTensor parameters placed by ``param_specs()`` run
tensor-parallel: self- and cross-attention on the rank's kv slots of the
packed layout (``bq``, ``bv`` sharded with them), the MLP on its ``ff``
columns (``b_in`` too), each output projection row-parallel and reduced
before its replicated bias (``bo``, ``b_out``) is added, once. The
embedding is a vocab-parallel lookup and the tied logits an all-gather of
the ranks' vocab columns; the caches come back sharded on their kv slots.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (
    ParallelConfig, from_local, gqa_layout, local_tree)
from repro_torch.models import layers as L
from repro_torch.models.param_utils import (
    abstract_params, count_params, init_params, param_shardings, param_specs,
    t, unstack)
from repro_torch.models.transformer import _DTYPES


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    log_timescale = math.log(10_000) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  dtype=torch.float32,
                                                  device=device))
    scaled = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
              * inv[None, :])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


class WhisperModel(TP.MeshModel, nn.Module):
    """Encoder-decoder model over an explicit parameter tree."""

    KERNELS = ()

    def __init__(self, cfg: ModelConfig, pc: Optional[ParallelConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.pc = pc or ParallelConfig.single_device()
        self.layout = gqa_layout(cfg.num_heads, cfg.num_kv_heads, self.pc.tp)
        self.n_groups = cfg.num_layers
        self.group = 1

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def supports_paged(self) -> bool:
        return False

    # ---------------------------------------------------------------- params
    def _attn_templates(self, Lyr: int):
        cfg, lay = self.cfg, self.layout
        D, KVs, Qp, hd = cfg.d_model, lay.kv_slots, lay.q_per_slot, cfg.head_dim
        qmask_np = lay.q_array() >= 0
        dup = torch.as_tensor(lay.dup_array(), dtype=torch.long)

        def randn(gen, shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)

        def qmask(gen):
            return torch.as_tensor(qmask_np, dtype=torch.float32,
                                   device=gen.device)

        # each draws the first n of the Lyr layers (init_params' by_layer: 1)
        def init_wq(gen, n):
            w = randn(gen, (n, D, KVs, Qp, hd)).div_(math.sqrt(D))
            return w.mul_(qmask(gen)[None, None, :, :, None])

        def init_wo(gen, n):
            w = randn(gen, (n, KVs, Qp, hd, D)).div_(
                math.sqrt(lay.num_heads * hd))
            return w.mul_(qmask(gen)[None, :, :, None, None])

        def init_kv(gen, n):
            w = randn(gen, (n, D, lay.num_kv_heads, hd)).div_(math.sqrt(D))
            return w.index_select(2, dup.to(gen.device))

        return {
            "wq": t((Lyr, D, KVs, Qp, hd), (None, None, "kv_heads", None, None),
                    custom=init_wq),
            "bq": t((Lyr, KVs, Qp, hd), (None, "kv_heads", None, None), "zeros"),
            "wk": t((Lyr, D, KVs, hd), (None, None, "kv_heads", None), custom=init_kv),
            "wv": t((Lyr, D, KVs, hd), (None, None, "kv_heads", None), custom=init_kv),
            "bv": t((Lyr, KVs, hd), (None, "kv_heads", None), "zeros"),
            "wo": t((Lyr, KVs, Qp, hd, D), (None, "kv_heads", None, None, None),
                    custom=init_wo),
            "bo": t((Lyr, D), (None, None), "zeros"),
        }

    def _mlp_templates(self, Lyr: int):
        D, F_ = self.cfg.d_model, self.cfg.d_ff
        return {
            "w_in": t((Lyr, D, F_), (None, None, "ff"), fan_in=D),
            "b_in": t((Lyr, F_), (None, "ff"), "zeros"),
            "w_out": t((Lyr, F_, D), (None, "ff", None), fan_in=F_),
            "b_out": t((Lyr, D), (None, None), "zeros"),
        }

    def templates(self):
        cfg = self.cfg
        Le, Ld, D = cfg.num_encoder_layers, cfg.num_layers, cfg.d_model

        def norms(Lyr, names):
            out = {}
            for n in names:
                out[f"{n}_s"] = t((Lyr, D), (None, None), "ones")
                out[f"{n}_b"] = t((Lyr, D), (None, None), "zeros")
            return out

        enc = norms(Le, ("ln1", "ln2"))
        enc.update({f"sa_{k}": v for k, v in self._attn_templates(Le).items()})
        enc.update(self._mlp_templates(Le))
        dec = norms(Ld, ("ln1", "ln2", "ln3"))
        dec.update({f"sa_{k}": v for k, v in self._attn_templates(Ld).items()})
        dec.update({f"xa_{k}": v for k, v in self._attn_templates(Ld).items()})
        dec.update(self._mlp_templates(Ld))
        return {
            "embed": t((cfg.padded_vocab(self.pc.tp), D), ("vocab", None), fan_in=D),
            "pos_dec": t((cfg.max_target_len, D), (None, None), fan_in=D),
            "enc": enc,
            "dec": dec,
            "enc_norm_s": t((D,), (None,), "ones"),
            "enc_norm_b": t((D,), (None,), "zeros"),
            "dec_norm_s": t((D,), (None,), "ones"),
            "dec_norm_b": t((D,), (None,), "zeros"),
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

    def cache_struct(self, batch: int, max_len: int):
        """Shapes and dtypes of ``prefill``'s cache (``meta`` tensors);
        ``max_len`` is the encoder's length, the self-attention cache takes
        ``max_target_len``."""
        cfg = self.cfg
        Ld, T = cfg.num_layers, cfg.max_target_len
        kv = (self.layout.kv_slots, cfg.head_dim)

        def meta(*shape, dtype=None):
            return torch.empty(shape, dtype=dtype or self.dtype, device="meta")
        return {"k_self": meta(Ld, batch, T, *kv), "v_self": meta(Ld, batch, T, *kv),
                "k_cross": meta(Ld, batch, max_len, *kv),
                "v_cross": meta(Ld, batch, max_len, *kv),
                "frame_lens": meta(batch, dtype=torch.int32)}

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeros of ``cache_struct(batch, max_len)`` on ``device``."""
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                for k, s in self.cache_struct(batch, max_len).items()}

    def with_layers(self, num_layers: int) -> "WhisperModel":
        """Same arch with ``num_layers`` encoder and decoder layers."""
        m = type(self)(self.cfg.replace(num_layers=num_layers,
                                        num_encoder_layers=num_layers), self.pc)
        m.mesh = self.mesh
        return m

    @property
    def scan_trip_count(self) -> int:
        return self.n_groups

    @property
    def layers_per_scan_step(self) -> int:
        return 1

    def cache_specs(self):
        kv = self.pc.spec(None, "batch", None, "kv_heads", None)
        return {"k_self": kv, "v_self": kv, "k_cross": kv, "v_cross": kv,
                "frame_lens": self.pc.spec("batch")}

    # ---------------------------------------------------------------- blocks
    @staticmethod
    def _proj_in(x, w):
        """x [..., D] @ w [D, *heads] -> [..., *heads]."""
        D = x.shape[-1]
        return (x @ w.reshape(D, -1)).reshape(*x.shape[:-1], *w.shape[1:])

    def _q(self, pp, prefix, x):
        """x (entered the region) -> the rank's q slots."""
        return self._proj_in(x, pp[f"{prefix}_wq"]) + pp[f"{prefix}_bq"]

    def _kv(self, pp, prefix, x):
        return (self._proj_in(x, pp[f"{prefix}_wk"]),
                self._proj_in(x, pp[f"{prefix}_wv"]) + pp[f"{prefix}_bv"])

    def _proj_out(self, pp, prefix, o):
        """o [..., G, Qp, hd] @ wo [G, Qp, hd, D] (reduced over the ranks'
        slots) + bo -> [..., D]."""
        wo = pp[f"{prefix}_wo"]
        return (self._region.reduce(o.reshape(*o.shape[:-3], -1)
                                    @ wo.reshape(-1, wo.shape[-1]))
                + pp[f"{prefix}_bo"])

    def _mlp(self, pp, h):
        return L.gelu_mlp(h, pp["w_in"], pp["b_in"], pp["w_out"], pp["b_out"],
                          self._region)

    def _enc_block(self, x, pp, frame_lens):
        cfg = self.cfg
        pp = self._region.gather_group("enc", pp)
        h = self._region.enter(L.layernorm(x, pp["ln1_s"], pp["ln1_b"],
                                           cfg.norm_eps))
        q, (k, v) = self._q(pp, "sa", h), self._kv(pp, "sa", h)
        o = L.block_attention(q, k, v, causal=False, seq_lens=frame_lens)
        x = x + self._proj_out(pp, "sa", o)
        h = L.layernorm(x, pp["ln2_s"], pp["ln2_b"], cfg.norm_eps)
        return x + self._mlp(pp, h)

    def encode(self, params, frames, frame_lens=None):
        """frames: [B, S, D] stub frontend embeddings -> encoder hidden."""
        cfg = self.cfg
        S = frames.shape[1]
        x = (frames.to(self.dtype)
             + sinusoids(S, cfg.d_model, frames.device).to(self.dtype))
        for pp in unstack(params["enc"]):
            x = self._enc_block(x, pp, frame_lens)
        return L.layernorm(x, params["enc_norm_s"], params["enc_norm_b"],
                           cfg.norm_eps)

    def _dec_block_seq(self, x, pp, enc_out, frame_lens):
        cfg = self.cfg
        enter = self._region.enter
        pp = self._region.gather_group("dec", pp)
        h = enter(L.layernorm(x, pp["ln1_s"], pp["ln1_b"], cfg.norm_eps))
        q, (k, v) = self._q(pp, "sa", h), self._kv(pp, "sa", h)
        o = L.block_attention(q, k, v, causal=True)
        x = x + self._proj_out(pp, "sa", o)
        h = L.layernorm(x, pp["ln2_s"], pp["ln2_b"], cfg.norm_eps)
        qx = self._q(pp, "xa", enter(h))
        kx, vx = self._kv(pp, "xa", enter(enc_out))
        ox = L.block_attention(qx, kx, vx, causal=False, seq_lens=frame_lens)
        x = x + self._proj_out(pp, "xa", ox)
        h = L.layernorm(x, pp["ln3_s"], pp["ln3_b"], cfg.norm_eps)
        return x + self._mlp(pp, h), (k, v, kx, vx)

    def _decode_tokens(self, params, tokens, enc_out, frame_lens):
        """Decoder over the whole prompt -> (hidden, per-layer (k, v, k_cross,
        v_cross) stacked ``[Ld, ...]``)."""
        T = tokens.shape[1]
        x = self._region.lookup(params["embed"], tokens).to(self.dtype)
        x = x + params["pos_dec"][:T][None]
        caches = []
        for pp in unstack(params["dec"]):
            x, c = self._dec_block_seq(x, pp, enc_out, frame_lens)
            caches.append(c)
        x = L.layernorm(x, params["dec_norm_s"], params["dec_norm_b"],
                        self.cfg.norm_eps)
        return x, tuple(torch.stack(c) for c in zip(*caches))

    def logits(self, params, hidden):
        return L.vocab_logits(hidden, params["embed"].T, self.cfg.vocab_size,
                              self._region)

    # ---------------------------------------------------------------- steps
    def train_loss(self, params, batch, *, remat=True):
        """batch: {'frames': [B, S, D], 'tokens': [B, T], 'labels': [B, T],
        'frame_lens': optional [B]} -> (loss, metrics), differentiable in
        ``params``. ``remat`` is taken and unused, as in the reference. On a
        mesh each rank takes its rows of ``batch`` and the loss is the whole
        batch's, on every rank."""
        if self._sharded(params):
            with self._tp_region():
                return self.train_loss(
                    self._local_params(params),
                    {k: self._rows(v) for k, v in batch.items()}, remat=remat)
        frame_lens = batch.get("frame_lens")
        enc_out = self.encode(params, batch["frames"], frame_lens)
        hidden, _ = self._decode_tokens(params, batch["tokens"], enc_out,
                                        frame_lens)
        region = self._region
        total, count = L.chunked_softmax_xent(
            hidden, params["embed"].T, batch["labels"], num_chunks=4,
            vocab_valid=self.cfg.vocab_size, region=region)
        total, count = region.reduce_dp(total), region.reduce_dp(count)
        loss = total / torch.clamp(count, min=1.0)
        return loss, {"xent": loss}

    @torch.no_grad()
    def prefill(self, params, tokens, *, frames=None, seq_lens=None,
                max_len: int = 0, extra_embeds=None):
        """tokens: decoder prompt [B, Tp]; frames (or extra_embeds): encoder
        frame embeddings [B, S, D]; seq_lens: valid frames per row ->
        (last-token logits [B, V], cache). ``max_len`` is unused. On a mesh
        (DTensor params) the logits are a DTensor sharded on the batch and
        the cache DTensors placed by ``cache_specs()``."""
        frames = frames if frames is not None else extra_embeds
        if frames is None:
            raise ValueError(f"{self.cfg.name}: prefill needs encoder frames "
                             f"[B, S, D]")
        if self._sharded(params):
            with self._tp_region():
                lg, cache = self.prefill(self._local_params(params),
                                         self._rows(tokens),
                                         frames=self._rows(frames),
                                         seq_lens=self._rows(seq_lens))
            specs = self.cache_specs()
            return self._by_batch(lg), {k: from_local(v, self.mesh, specs[k])
                                        for k, v in cache.items()}
        B, Tp = tokens.shape
        enc_out = self.encode(params, frames, seq_lens)
        hidden, (k_self, v_self, k_cross, v_cross) = self._decode_tokens(
            params, tokens, enc_out, seq_lens)
        pad = (0, 0, 0, 0, 0, self.cfg.max_target_len - Tp)
        cache = {
            "k_self": torch.nn.functional.pad(k_self, pad),
            "v_self": torch.nn.functional.pad(v_self, pad),
            "k_cross": k_cross, "v_cross": v_cross,
            "frame_lens": (seq_lens if seq_lens is not None else torch.full(
                (B,), frames.shape[1], dtype=torch.int32,
                device=tokens.device)),
        }
        return self.logits(params, hidden[:, -1]), cache

    def _dec_block_step(self, x, pp, cache, g, positions):
        cfg = self.cfg
        enter = self._region.enter
        h = enter(L.layernorm(x, pp["ln1_s"], pp["ln1_b"], cfg.norm_eps))
        q, (k, v) = self._q(pp, "sa", h), self._kv(pp, "sa", h)
        kc = L.cache_write(cache["k_self"][g], k, positions)
        vc = L.cache_write(cache["v_self"][g], v, positions)
        o = L.decode_attention(q, kc, vc, positions)
        x = x + self._proj_out(pp, "sa", o)
        h = L.layernorm(x, pp["ln2_s"], pp["ln2_b"], cfg.norm_eps)
        qx = self._q(pp, "xa", enter(h))
        ox = L.decode_attention(qx, cache["k_cross"][g], cache["v_cross"][g],
                                cache["frame_lens"] - 1)
        x = x + self._proj_out(pp, "xa", ox)
        h = L.layernorm(x, pp["ln3_s"], pp["ln3_b"], cfg.norm_eps)
        return x + self._mlp(pp, h)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """tokens/positions: [B]; positions index the *decoder* sequence ->
        (logits [B, V], cache), the self-attention K/V written in place. On a
        mesh (DTensor params and cache) each rank steps its rows and writes
        its cache shard."""
        if self._sharded(params):
            with self._tp_region():
                lg, _ = self.decode_step(self._local_params(params),
                                         local_tree(cache), self._rows(tokens),
                                         self._rows(positions))
            return self._by_batch(lg), cache
        T = self.cfg.max_target_len
        x = self._region.lookup(params["embed"], tokens).to(self.dtype)
        x = x + params["pos_dec"][positions.long().clamp(max=T - 1)]
        for g, pp in enumerate(unstack(params["dec"])):
            x = self._dec_block_step(x, pp, cache, g, positions)
        x = L.layernorm(x, params["dec_norm_s"], params["dec_norm_b"],
                        self.cfg.norm_eps)
        return self.logits(params, x), cache
