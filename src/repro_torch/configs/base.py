"""Architecture/config system.

Every assigned architecture is a frozen ``ModelConfig``; shapes are ``ShapeConfig``.
Configs are pure data — no jax imports here so they can be loaded anywhere
(launchers, schedulers, docs tooling) without touching device state.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Static model architecture description (one per assigned arch)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    attn_kind: str = "full"  # full | local_global | swa | linear | none
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0          # window size for swa/local layers
    local_global_pattern: int = 0    # N local layers per 1 global (gemma3: 5)
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                # silu | gelu

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid (hymba) / rwkv
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    max_target_len: int = 448

    # vlm
    num_vision_patches: int = 0      # patch embeddings prepended by the stub frontend

    dtype: str = "bfloat16"
    source: str = ""                 # provenance tag from the assignment table

    # ---- derived helpers ------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def attention_free(self) -> bool:
        return self.attn_kind == "none" or self.attn_kind == "linear"

    def padded_heads(self, tp: int) -> int:
        """Q heads physically padded to a TP multiple (zero-weight padding)."""
        return _round_up(self.num_heads, tp)

    def padded_kv_heads(self, tp: int) -> int:
        """KV heads padded to a TP multiple when sharded; replicated if tp == 1."""
        if tp <= 1:
            return self.num_kv_heads
        return _round_up(self.num_kv_heads, tp)

    def padded_vocab(self, tp: int) -> int:
        """Vocab rows padded to a TP multiple (pad logits masked to -inf)."""
        return _round_up(self.vocab_size, tp) if tp > 1 else self.vocab_size

    def num_params(self) -> int:
        """Total parameter count N (analytic, unpadded, used for MODEL_FLOPS)."""
        return _param_count(self, active_only=False)

    def num_active_params(self) -> int:
        """Active-per-token parameter count (== num_params for dense)."""
        return _param_count(self, active_only=True)

    def supports_shape(self, shape: "ShapeConfig") -> bool:
        if shape.kind == "long_decode":
            # only sub-quadratic archs run 500k contexts
            return self.attn_kind in ("local_global", "swa", "linear", "none") or (
                self.family in ("ssm", "hybrid")
            )
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str          # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int
    grad_accum: int = 1   # training microbatching (fit-to-HBM knob)

    @property
    def is_training(self) -> bool:
        return self.kind == "train"

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "long_decode", 524288, 1)

ALL_SHAPES: Sequence[ShapeConfig] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """Analytic parameter count; for MoE ``active_only`` counts top-k experts."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd) + (cfg.num_heads * hd) * d
    if cfg.attn_kind == "linear":  # rwkv6 time-mix replaces attention
        # r,k,v,g,o projections + decay/mix loras (approx; exact counted from params)
        attn = 5 * d * d + d * (2 * cfg.rwkv_decay_lora) + 5 * d * (2 * cfg.rwkv_mix_lora)
    if cfg.num_experts > 0:
        e = cfg.num_experts_per_tok if active_only else cfg.num_experts
        ffn = e * (3 * d * cfg.d_ff) + d * cfg.num_experts  # router
    else:
        ffn = 3 * d * cfg.d_ff if cfg.act in ("silu",) else 2 * d * cfg.d_ff
    if cfg.family == "hybrid":
        # parallel mamba branch per layer (in/out proj + conv + ssm params)
        d_in = cfg.ssm_expand * d
        attn += 2 * d * d_in + d_in * cfg.ssm_conv + d_in * (2 * cfg.ssm_state + 2) + d_in * d
    layer = attn + ffn
    total = cfg.num_layers * layer
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.is_encoder_decoder:
        # encoder layers: self-attn + mlp; decoder already counted (adds cross-attn)
        enc_layer = 4 * d * d + 2 * d * cfg.d_ff
        total += cfg.num_encoder_layers * enc_layer + cfg.num_layers * 4 * d * d
    return int(total)
