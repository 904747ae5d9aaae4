"""rwkv6-7b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,                  # channel-mix hidden (3.5x)
    vocab_size=65536,
    attn_kind="linear",
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    act="relu2",                 # channel-mix uses squared ReLU
    source="arXiv:2404.05892; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    rwkv_head_dim=16,
    d_ff=224,
    vocab_size=256,
    rwkv_decay_lora=8,
    rwkv_mix_lora=4,
)
