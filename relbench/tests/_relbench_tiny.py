"""Small configurations and mixes the relbench tests run on the CPU."""
import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(dtype: str = "float32", bias: bool = True) -> dict:
    """A tiny dense transformer in a configuration file's keys."""
    return {"name": "tiny", "source": "test", "hidden_act": "silu",
            "hidden_size": 64, "intermediate_size": 128,
            "num_attention_heads": 4, "num_hidden_layers": 2,
            "num_key_value_heads": 2, "head_dim": 16, "qkv_bias": bias,
            "rms_norm_eps": 1e-5, "rope_theta": 1e6,
            "tie_word_embeddings": False, "torch_dtype": dtype,
            "vocab_size": 50000,
            # float32 on both sides: the served tokens are the reference's
            "check": {"served_logit_gap": 1e-3},
            "serving": {"max_slots": 8, "max_len": 576, "block_size": 16}}


def mix(name: str, **kw) -> dict:
    m = copy.deepcopy(json.loads((BENCH / "traffic" / f"{name}.json").read_text()))
    m.update(kw)
    return m
