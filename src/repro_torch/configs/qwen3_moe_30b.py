"""qwen3-moe-30b-a3b — MoE 128 experts top-8, GQA. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                    # per-expert intermediate size
    vocab_size=151936,
    attn_kind="full",
    qk_norm=True,
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-30b-a3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=2,
    moe_capacity_factor=8.0,     # == num_experts: zero capacity drops (exactness tests)
)
