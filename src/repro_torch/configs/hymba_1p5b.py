"""hymba-1.5b — hybrid: parallel attention + mamba heads in each layer. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind="swa",             # attention branch is sliding-window (long-context viable)
    sliding_window=1024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="hymba-1.5b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    ssm_state=4,
)
