"""qwen3-1.7b — dense, GQA, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    attn_kind="full",
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-1.7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
