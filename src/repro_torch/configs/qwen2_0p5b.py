"""qwen2-0.5b — dense, GQA (kv=2), QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attn_kind="full",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2-0.5b-smoke",
    num_layers=2,
    d_model=48,
    num_heads=3,   # deliberately non-power-of-two, mirrors 14-head oddness
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
)
