"""gemma3-12b — dense, 5:1 local:global attention, 128k. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    attn_kind="local_global",
    local_global_pattern=5,      # 5 sliding-window layers : 1 global layer
    sliding_window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-1b-pt; unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    name="gemma3-12b-smoke",
    num_layers=6,                # one full 5:1 local:global group
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
)
