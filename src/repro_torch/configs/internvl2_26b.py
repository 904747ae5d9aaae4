"""internvl2-26b — VLM: InternViT (stub) + InternLM2 backbone. [arXiv:2404.16821; hf]

The vision frontend is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings (``num_vision_patches`` per request) which the LM
consumes prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attn_kind="full",
    rope_theta=1_000_000.0,
    num_vision_patches=1024,
    source="arXiv:2404.16821; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-26b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_vision_patches=8,
)
