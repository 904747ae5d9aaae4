"""whisper-base — encoder-decoder audio backbone; conv frontend is a stub. [arXiv:2212.04356; unverified]

Shape interpretation (see DESIGN.md §5): ``seq_len`` is the number of encoder
*frame embeddings* (supplied precomputed by the stub frontend); the decoder side
is capped at ``max_target_len`` text tokens. ``decode_*`` shapes decode one text
token against a cross-attention KV of ``seq_len`` frames.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                # decoder layers
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    attn_kind="full",
    is_encoder_decoder=True,
    max_target_len=448,
    act="gelu",
    rope_theta=0.0,              # whisper uses learned/sinusoidal positions, not rope
    source="arXiv:2212.04356; unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-base-smoke",
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    max_target_len=16,
)
