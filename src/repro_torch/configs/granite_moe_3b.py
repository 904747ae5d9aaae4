"""granite-moe-3b-a800m — MoE 40 experts top-8, GQA. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                    # per-expert intermediate size
    vocab_size=49155,
    attn_kind="full",
    num_experts=40,
    num_experts_per_tok=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-moe-3b-a800m-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=5,               # deliberately non-divisible by smoke TP
    num_experts_per_tok=2,
    moe_capacity_factor=5.0,     # == num_experts: zero capacity drops (exactness tests)
)
