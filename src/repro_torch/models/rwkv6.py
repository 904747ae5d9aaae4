"""RWKV6 "Finch": attention-free token mixing with data-dependent per-channel
decay. The PyTorch counterpart of ``repro/models/rwkv6.py::RWKV6Model``.

Prefill runs the chunked form of the WKV recurrence over chunks of
``_chunk_size(S)`` tokens, carrying a ``[B, H, K, V]`` float32 state: one
call of ``ops.rwkv6_chunk`` per layer (for CUDA tensors the hand-written
CUDA kernels: a chunk-parallel pass and the state carry; on the CPU their
plain version, a loop over the chunks). The kernel takes the chunk lengths of
``CHUNKS`` only; for any other ``_chunk_size(S)`` the CUDA path walks the
sequence at ``kernel_chunking(S)`` instead (see ``wkv_padded``). The chunked
form is exact for any chunk length, so only the float32 rounding differs.
Decode is the one-token recurrence ``wkv6_decode`` in plain PyTorch, as the
reference has no kernel for it.

Parameters are an explicit tree of tensors with the reference's keys and
layouts (per-layer params stacked ``[L, ...]``), so weights carry across from
the JAX package unchanged (``repro_torch.bridge``). Caches keep the
reference's layouts: ``state [L, B, H, K, V]`` in float32 and ``tm_shift`` /
``cm_shift [L, B, D]`` in the model dtype. The dtype flow is the
reference's: products of model-dtype operands, the decay and the bonus in
float32, the WKV output and its group norm in float32, cast back to the model
dtype before the gate.

On a mesh (``model.mesh``; ``TP.MeshModel``) ``prefill``, ``decode_step``
and ``train_loss`` given DTensor parameters placed by ``param_specs()`` run
tensor-parallel, where the reference leaves the partitioning to GSPMD: each
rank takes its rows of the batch and its ``ff`` columns of ``w_r``, ``w_k``,
``w_v`` and ``w_g``, so its H/tp whole WKV heads, on which the recurrence
(``rwkv6_chunk`` on CUDA) and the per-head group norm run; ``w_o`` is
row-parallel (one all-reduce). The ddlerp and decay weights are replicated
and enter the region (their gradients summed over the model axis); each rank
takes its heads' columns of the decay, ``bonus`` and ``gn``. In the channel
mix ``wc_k`` and ``wc_r`` are column-parallel and ``wc_v`` row-parallel: the
gate's columns are all-gathered and the partial sum over the ``ff`` columns
all-reduced before their product. The embedding, logits and loss are the
dense family's vocab-parallel ones; the state cache comes back sharded on
its heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import ParallelConfig, from_local, local_tree
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6_chunk import CHUNKS
from repro_torch.models import layers as L
from repro_torch.models.param_utils import (
    abstract_params, count_params, init_params, param_shardings, param_specs,
    t, unstack)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MIX_NAMES = ("w", "k", "v", "r", "g")
CACHE_NAMES = ("state", "tm_shift", "cm_shift")


def _chunk_size(seq: int) -> int:
    # <= 128 chunk steps; chunks of at least 16 tokens
    c = max(16, seq // 128)
    while seq % c:
        c //= 2
    return max(c, 1)


def kernel_chunking(seq: int) -> Tuple[int, int]:
    """(chunk, padded length) of a sequence of ``seq`` tokens on the kernel,
    which takes the chunk lengths of ``CHUNKS`` only: ``_chunk_size(seq)``
    where that is one of them; else the longest of ``CHUNKS`` that divides
    ``seq``; else ``seq`` padded up to a multiple of the shortest."""
    c = _chunk_size(seq)
    if c in CHUNKS:
        return c, seq
    for c in sorted(CHUNKS, reverse=True):
        if seq % c == 0:
            return c, seq
    c = min(CHUNKS)
    return c, -(-seq // c) * c


def wkv_padded(fn, r, k, v, logw, u, state):
    """``fn`` (``ops.rwkv6_chunk`` or its plain version) over the sequence at
    ``kernel_chunking(S)``. Pad tokens are masked as the model masks pad rows
    (k := 0, logw := 0), so they leave the state exactly as it was; their rows
    of ``o`` are cut off. Returns (o [B, S, H, V] float32, state)."""
    S = r.shape[1]
    c, padded = kernel_chunking(S)
    if padded > S:
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, padded - S))
                         for x in (r, k, v, logw))
    o, state = fn(r, k, v, logw, u, state, out_dtype=torch.float32, chunk=c)
    return o[:, :S], state


def wkv6_decode(r, k, v, logw, u, state):
    """Single-token WKV6 step in float32. r/k/v/logw: [B, H, K];
    state: [B, H, K, V] -> (out [B, H, V], new state)."""
    r, k, v, logw = (x.float() for x in (r, k, v, logw))
    state = state.float()
    kv = k[..., :, None] * v[..., None, :]                 # [B, H, K, V]
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    new_state = state * torch.exp(logw)[..., None] + kv
    return out, new_state


class RWKV6Model(TP.MeshModel, nn.Module):
    """Inference model over an explicit parameter tree."""

    # kernels the model's sequence path launches on CUDA
    KERNELS = ("rwkv6_chunk",)
    # every decode step folds its token into each row's state
    RECURRENT_CACHE = True
    # WKV implementation: 'kernel' goes through ops.rwkv6_chunk (the CUDA
    # kernel for CUDA tensors, the plain version on the CPU); 'plain' always
    # runs the plain version. Instance-level; see with_wkv_impl().
    wkv_impl = "kernel"

    def __init__(self, cfg: ModelConfig, pc: Optional[ParallelConfig] = None):
        super().__init__()
        if cfg.d_model % cfg.rwkv_head_dim:
            raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a "
                             f"multiple of rwkv_head_dim {cfg.rwkv_head_dim}")
        self.cfg = cfg
        self.pc = pc or ParallelConfig.single_device()
        self.n_heads = cfg.d_model // cfg.rwkv_head_dim
        self.n_groups = cfg.num_layers
        self.group = 1

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ---------------------------------------------------------------- params
    def templates(self):
        cfg = self.cfg
        Lyr, D, F_ = cfg.num_layers, cfg.d_model, cfg.d_ff
        mlo, dlo = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
        blocks = {
            "ln1_s": t((Lyr, D), (None, None), "ones"),
            "ln1_b": t((Lyr, D), (None, None), "zeros"),
            "ln2_s": t((Lyr, D), (None, None), "ones"),
            "ln2_b": t((Lyr, D), (None, None), "zeros"),
            # time-mix ddlerp
            "mu_base": t((Lyr, D), (None, None), "zeros"),
            "mu": t((Lyr, 5, D), (None, None, None), "zeros"),
            "lora_a": t((Lyr, D, 5 * mlo), (None, None, None), fan_in=D),
            "lora_b": t((Lyr, 5, mlo, D), (None, None, None, None), "zeros"),
            # projections
            "w_r": t((Lyr, D, D), (None, None, "ff"), fan_in=D),
            "w_k": t((Lyr, D, D), (None, None, "ff"), fan_in=D),
            "w_v": t((Lyr, D, D), (None, None, "ff"), fan_in=D),
            "w_g": t((Lyr, D, D), (None, None, "ff"), fan_in=D),
            "w_o": t((Lyr, D, D), (None, "ff", None), fan_in=D),
            # decay
            "w0": t((Lyr, D), (None, None), "zeros"),
            "wd1": t((Lyr, D, dlo), (None, None, None), fan_in=D),
            "wd2": t((Lyr, dlo, D), (None, None, None), "zeros"),
            "bonus": t((Lyr, D), (None, None), "zeros"),
            "gn": t((Lyr, D), (None, None), "ones"),
            # channel-mix
            "mu_ck": t((Lyr, D), (None, None), "zeros"),
            "mu_cr": t((Lyr, D), (None, None), "zeros"),
            "wc_k": t((Lyr, D, F_), (None, None, "ff"), fan_in=D),
            "wc_v": t((Lyr, F_, D), (None, "ff", None), fan_in=F_),
            "wc_r": t((Lyr, D, D), (None, None, "ff"), fan_in=D),
        }
        Vp = cfg.padded_vocab(self.pc.tp)
        return {
            "embed": t((Vp, D), ("vocab", None), fan_in=D),
            "ln0_s": t((D,), (None,), "ones"),
            "ln0_b": t((D,), (None,), "zeros"),
            "blocks": blocks,
            "final_norm": t((D,), (None,), "zeros"),
            "lm_head": t((D, Vp), (None, "vocab"), fan_in=D),
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
    def init_cache(self, batch: int, max_len: int = 0, device=None):
        """Recurrent cache: ``state [L, batch, H, K, K]`` float32 and the
        token-shift rows ``tm_shift`` / ``cm_shift [L, batch, D]``.
        ``max_len`` is unused: the cache does not grow with the sequence."""
        cfg = self.cfg
        H, K, Lyr = self.n_heads, cfg.rwkv_head_dim, cfg.num_layers
        return {
            "state": torch.zeros((Lyr, batch, H, K, K), dtype=torch.float32,
                                 device=device),
            "tm_shift": torch.zeros((Lyr, batch, cfg.d_model),
                                    dtype=self.dtype, device=device),
            "cm_shift": torch.zeros((Lyr, batch, cfg.d_model),
                                    dtype=self.dtype, device=device),
        }

    def cache_struct(self, batch: int, max_len: int = 0):
        """Shapes and dtypes of ``init_cache``'s tree (``meta`` tensors)."""
        return self.init_cache(batch, max_len, device="meta")

    @property
    def scan_trip_count(self) -> int:
        return self.cfg.num_layers

    @property
    def layers_per_scan_step(self) -> int:
        return 1

    def cache_specs(self):
        return {
            "state": self.pc.spec(None, "batch", "heads", None, None),
            "tm_shift": self.pc.spec(None, "batch", None),
            "cm_shift": self.pc.spec(None, "batch", None),
        }

    @staticmethod
    def cache_slot_axes() -> Dict[str, int]:
        """Axis of each cache entry that indexes the sequence (slot)."""
        return {name: 1 for name in CACHE_NAMES}

    def supports_paged(self) -> bool:
        """The recurrent cache has no pages: dense backend only."""
        return False

    # ------------------------------------------------------------- internals
    def _replicated(self, pp, *names):
        """Replicated weights used in the region: their gradients summed over
        the model axis (each rank's reaches only its own columns)."""
        return [self._region.enter(pp[n]) for n in names]

    def _ddlerp(self, pp, x, x_prev):
        """Data-dependent token-shift interpolation -> dict of mixed inputs."""
        mu_base, mu, lora_a, lora_b = self._replicated(
            pp, "mu_base", "mu", "lora_a", "lora_b")
        dx = x_prev - x
        base = x + dx * mu_base
        lora = torch.tanh(base @ lora_a)
        mlo = self.cfg.rwkv_mix_lora
        mixed = {}
        for i, name in enumerate(MIX_NAMES):
            delta = lora[..., i * mlo:(i + 1) * mlo] @ lora_b[i]
            mixed[name] = x + dx * (mu[i] + delta)
        return mixed

    def _decay(self, pp, mix_w):
        """The log decay of the rank's channels."""
        cols = self._region.cols
        w0, wd1, wd2 = self._replicated(pp, "w0", "wd1", "wd2")
        dw = cols(w0).float() + (torch.tanh(mix_w @ wd1) @ cols(wd2)).float()
        # log decay in [-~20, -1e-9]: w = exp(-exp(dw))
        return -torch.exp(torch.clamp(dw, -20.0, 10.0))

    def _heads(self, x):
        return x.reshape(*x.shape[:-1], -1, self.cfg.rwkv_head_dim)

    def _time_mix_in(self, pp, m):
        """The mixed inputs -> r, k, v, logw of the rank's heads [..., H/tp,
        K], the gate g [..., D/tp] and the bonus u [H/tp, K] in float32."""
        r = self._heads(m["r"] @ pp["w_r"])
        k = self._heads(m["k"] @ pp["w_k"])
        v = self._heads(m["v"] @ pp["w_v"])
        g = m["g"] @ pp["w_g"]
        logw = self._heads(self._decay(pp, m["w"]))
        (bonus,) = self._replicated(pp, "bonus")
        u = self._heads(self._region.cols(bonus).float())
        return r, k, v, logw, g, u

    def _time_mix_out(self, pp, o, g):
        """The WKV output o [..., H/tp, V] (float32) normalized per head,
        gated and projected by the row-parallel ``w_o`` (reduced)."""
        (gn,) = self._replicated(pp, "gn")
        o = L.groupnorm_heads(o, o.new_ones(())).reshape(g.shape)
        o = (o * self._region.cols(gn).float()).to(self.dtype)
        o = o * F.silu(g.float()).to(self.dtype)
        return self._region.reduce(o @ pp["w_o"])

    def _channel_mix(self, pp, x, x_prev):
        """x has entered the region. ``wc_r`` is column-parallel like
        ``wc_k``: the rank's gate columns are gathered and the partial sum
        over its ``ff`` columns reduced before their product."""
        mu_ck, mu_cr = self._replicated(pp, "mu_ck", "mu_cr")
        mk = x + (x_prev - x) * mu_ck
        mr = x + (x_prev - x) * mu_cr
        kk = torch.square(F.relu(mk @ pp["wc_k"]))
        region = self._region
        return (region.gather(torch.sigmoid(mr @ pp["wc_r"]), -1)
                * region.reduce(kk @ pp["wc_v"]))

    def _wkv(self, r, k, v, logw, u, state, *, chunk):
        """The recurrence over the whole sequence in chunks of ``chunk``
        tokens, with ``o`` kept in float32 as the model's ``wkv6_chunk``
        keeps it (the Pallas kernel writes r's dtype). On CUDA the kernel
        runs at ``kernel_chunking(S)``, which is ``chunk`` wherever it takes
        it; on the CPU ``ops`` runs the plain version at ``chunk``."""
        if self.wkv_impl == "plain":
            return ref.rwkv6_chunk_plain(r, k, v, logw, u, state,
                                         out_dtype=torch.float32, chunk=chunk)
        if r.device.type != "cpu":
            return wkv_padded(ops.rwkv6_chunk, r, k, v, logw, u, state)
        return ops.rwkv6_chunk(r, k, v, logw, u, state,
                               out_dtype=torch.float32, chunk=chunk)

    def _time_mix_seq(self, pp, x, boundary, valid=None):
        """x: [B, S, D] post-ln1; boundary: [B, D] last token of the previous
        context; valid: [B, S] mask — pad tokens leave the WKV state untouched
        (k := 0 kills their contribution, log w := 0 freezes decay)."""
        B, S, D = x.shape
        K = self.cfg.rwkv_head_dim
        x = self._region.enter(x)
        x_prev = torch.cat([boundary[:, None], x[:, :-1]], dim=1)
        r, k, v, logw, g, u = self._time_mix_in(pp, self._ddlerp(pp, x, x_prev))
        if valid is not None:
            vm = valid[:, :, None, None]
            k = k * vm.to(k.dtype)
            logw = logw * vm
        c = _chunk_size(S)
        state = torch.zeros((B, r.shape[2], K, K), dtype=torch.float32,
                            device=x.device)
        o, state = self._wkv(r, k, v, logw, u, state, chunk=c)
        return self._time_mix_out(pp, o, g), state, x[:, -1]

    def _channel_mix_seq(self, pp, x, boundary):
        x = self._region.enter(x)
        x_prev = torch.cat([boundary[:, None], x[:, :-1]], dim=1)
        return self._channel_mix(pp, x, x_prev), x[:, -1]

    def _block_seq(self, x, pp, collect: bool, seq_lens=None):
        cfg = self.cfg
        pp = self._region.gather_group("blocks", pp)
        B, S = x.shape[:2]
        valid = None
        if seq_lens is not None:
            valid = (torch.arange(S, device=x.device)[None, :]
                     < seq_lens[:, None]).float()
        h = L.layernorm(x, pp["ln1_s"], pp["ln1_b"], cfg.norm_eps)
        tm, state, tm_b = self._time_mix_seq(pp, h, torch.zeros_like(h[:, 0]),
                                             valid)
        x = x + tm
        h2 = L.layernorm(x, pp["ln2_s"], pp["ln2_b"], cfg.norm_eps)
        cm, cm_b = self._channel_mix_seq(pp, h2, torch.zeros_like(h2[:, 0]))
        x = x + cm
        if not collect:
            return x, {}
        if seq_lens is not None:  # token-shift boundaries at the last *valid* token
            rows = torch.arange(B, device=x.device)
            last = seq_lens.long() - 1
            tm_b, cm_b = h[rows, last], h2[rows, last]
        return x, {"state": state, "tm_shift": tm_b, "cm_shift": cm_b}

    # ------------------------------------------------------------- public steps
    def forward_hidden(self, params, embeds, *, collect_cache=False,
                       seq_lens=None, remat=False):
        """embeds: [B, S, D] -> (hidden [B, S, D], caches | {}), caches stacked
        ``[L, B, ...]`` as the reference's layer scan stacks them. ``remat``
        recomputes each layer's activations in the backward pass."""
        cfg = self.cfg
        x = L.layernorm(embeds, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
        per_layer = []
        region = self._region

        def block_seq(*args):   # the recomputation runs in the same region
            with self._in_region(region):
                return self._block_seq(*args)

        for pp in unstack(params["blocks"]):
            if remat:
                # no RNG state kept: the loss draws no random numbers, and
                # reading the CUDA generator's state fails under capture
                x, caches = checkpoint(block_seq, x, pp, collect_cache,
                                       seq_lens, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                x, caches = self._block_seq(x, pp, collect_cache, seq_lens)
            per_layer.append(caches)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if not collect_cache:
            return x, {}
        if not per_layer:  # no layer (a roofline's 0-layer variant)
            return x, self.init_cache(x.shape[0], device=x.device)
        return x, {name: torch.stack([c[name] for c in per_layer])
                   for name in CACHE_NAMES}

    def embed_tokens(self, params, tokens):
        return self._region.lookup(params["embed"], tokens).to(self.dtype)

    def logits(self, params, hidden):
        return L.vocab_logits(hidden, params["lm_head"], self.cfg.vocab_size,
                              self._region)

    def train_loss(self, params, batch, *, remat=True):
        """batch: {'tokens': [B, S], 'labels': [B, S] (-1 pad)} -> (loss,
        metrics), differentiable in ``params``. The WKV runs the plain chunk
        loop at ``_chunk_size(S)``, what the reference trains through: the
        kernel is forward-only. On a mesh each rank takes its rows of
        ``batch`` and the loss is the whole batch's, on every rank."""
        if self.wkv_impl != "plain":
            return self.with_wkv_impl("plain").train_loss(params, batch,
                                                          remat=remat)
        if self._sharded(params):
            with self._tp_region():
                return self.train_loss(
                    self._local_params(params),
                    {k: self._rows(v) for k, v in batch.items()}, remat=remat)
        embeds = self.embed_tokens(params, batch["tokens"])
        hidden, _ = self.forward_hidden(params, embeds, remat=remat)
        region = self._region
        total, count = L.chunked_softmax_xent(hidden, params["lm_head"],
                                              batch["labels"],
                                              vocab_valid=self.cfg.vocab_size,
                                              region=region)
        total, count = region.reduce_dp(total), region.reduce_dp(count)
        loss = total / torch.clamp(count, min=1.0)
        return loss, {"xent": loss}

    @torch.no_grad()
    def prefill(self, params, tokens, *, seq_lens=None, max_len: int = 0):
        """tokens [B, S] -> (last-token logits [B, V], caches). ``seq_lens``
        masks pad tokens out of the recurrence; ``max_len`` is unused. On a
        mesh (DTensor params) the logits are a DTensor sharded on the batch
        and the caches DTensors placed by ``cache_specs()``."""
        if self._sharded(params):
            with self._tp_region():
                lg, caches = self.prefill(self._local_params(params),
                                          self._rows(tokens),
                                          seq_lens=self._rows(seq_lens))
            specs = self.cache_specs()
            return self._by_batch(lg), {k: from_local(v, self.mesh, specs[k])
                                        for k, v in caches.items()}
        B = tokens.shape[0]
        embeds = self.embed_tokens(params, tokens)
        hidden, caches = self.forward_hidden(params, embeds, collect_cache=True,
                                             seq_lens=seq_lens)
        if seq_lens is not None:
            last = hidden[torch.arange(B, device=hidden.device),
                          seq_lens.long() - 1]
        else:
            last = hidden[:, -1]
        return self.logits(params, last), caches

    def _block_decode(self, x, pp, cache):
        cfg = self.cfg
        h = L.layernorm(x, pp["ln1_s"], pp["ln1_b"], cfg.norm_eps)
        r, k, v, logw, g, u = self._time_mix_in(
            pp, self._ddlerp(pp, h, cache["tm_shift"]))
        o, new_state = wkv6_decode(r, k, v, logw, u, cache["state"])
        x = x + self._time_mix_out(pp, o, g)
        h2 = L.layernorm(x, pp["ln2_s"], pp["ln2_b"], cfg.norm_eps)
        x = x + self._channel_mix(pp, h2, cache["cm_shift"])
        return x, {"state": new_state, "tm_shift": h, "cm_shift": h2}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """tokens: [B] int32 -> (logits [B, V], cache). Every row advances one
        token; each layer's state and shifts are written into ``cache`` in
        place. ``positions`` is unused: the recurrence has no positions. On
        a mesh (DTensor params and cache) each rank steps its rows on its
        heads and writes its cache shard."""
        if self._sharded(params):
            with self._tp_region():
                lg, _ = self.decode_step(self._local_params(params),
                                         local_tree(cache), self._rows(tokens),
                                         positions)
            return self._by_batch(lg), cache
        x = self.embed_tokens(params, tokens)
        x = L.layernorm(x, params["ln0_s"], params["ln0_b"], self.cfg.norm_eps)
        blocks = params["blocks"]
        for g in range(self.n_groups):
            pp = {k: v[g] for k, v in blocks.items()}
            x, new_g = self._block_decode(x, pp, {n: cache[n][g]
                                                  for n in CACHE_NAMES})
            for n in CACHE_NAMES:
                cache[n][g] = new_g[n]
        x = L.rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return self.logits(params, x), cache

    def _sibling(self, cfg: ModelConfig, wkv_impl: str) -> "RWKV6Model":
        m = type(self)(cfg, self.pc)
        m.wkv_impl = wkv_impl
        m.mesh = self.mesh
        return m

    def with_layers(self, num_layers: int) -> "RWKV6Model":
        return self._sibling(self.cfg.replace(num_layers=num_layers),
                             self.wkv_impl)

    def with_wkv_impl(self, impl: str) -> "RWKV6Model":
        """A sibling model instance (same config, same parameter tree) whose
        prefill WKV runs via ``impl`` ('kernel' | 'plain')."""
        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown WKV impl {impl!r}")
        return self._sibling(self.cfg, impl)
