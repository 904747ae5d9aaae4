"""The served model's weights, drawn by the benchmark from the run's seed.

One parameter tree, in the layout the port's dense transformer takes
(``build_real_engine(params=...)``) and the plain reference reads: per layer
the projections and MLP stacked as ``[layers, 1, ...]``, the query heads
packed as ``[kv_heads, q_per_kv]`` (query head ``h`` reads key/value head
``h // q_per_kv``), RMSNorm gains stored as their offset from one. Each leaf
is drawn by one ``normal_`` on the device in the served dtype, then scaled
in place: a few large calls, no float32 copy. The same seed gives the
same weights.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# standard deviations that are not 1/sqrt(fan_in)
NORM_STD = 0.1      # RMSNorm gains 1 + N(0, 0.1)
BIAS_STD = 0.1


def dims(cfg: dict) -> Dict[str, int]:
    """The sizes the tree and the FLOP counts need, from a config file."""
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {"L": cfg["num_hidden_layers"], "D": cfg["hidden_size"],
            "H": H, "KV": KV, "Qp": H // KV, "hd": cfg["head_dim"],
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def has_bias(cfg: dict) -> bool:
    return bool(cfg.get("qkv_bias", cfg.get("bias", False)))


def shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Leaf name -> (shape, std); block leaves are named ``blocks.<leaf>``."""
    d = dims(cfg)
    L, D, KV, Qp, hd, F, V = (d[k] for k in ("L", "D", "KV", "Qp", "hd", "F", "V"))
    out = {
        "embed": ((V, D), 1.0),
        "lm_head": ((D, V), 1 / math.sqrt(D)),
        "final_norm": ((D,), NORM_STD),
        "blocks.ln1": ((L, 1, D), NORM_STD),
        "blocks.ln2": ((L, 1, D), NORM_STD),
        "blocks.wq": ((L, 1, D, KV, Qp, hd), 1 / math.sqrt(D)),
        "blocks.wk": ((L, 1, D, KV, hd), 1 / math.sqrt(D)),
        "blocks.wv": ((L, 1, D, KV, hd), 1 / math.sqrt(D)),
        "blocks.wo": ((L, 1, KV, Qp, hd, D), 1 / math.sqrt(KV * Qp * hd)),
        "blocks.w_gate": ((L, 1, D, F), 1 / math.sqrt(D)),
        "blocks.w_up": ((L, 1, D, F), 1 / math.sqrt(D)),
        "blocks.w_down": ((L, 1, F, D), 1 / math.sqrt(F)),
    }
    if has_bias(cfg):
        out.update({"blocks.bq": ((L, 1, KV, Qp, hd), BIAS_STD),
                    "blocks.bk": ((L, 1, KV, hd), BIAS_STD),
                    "blocks.bv": ((L, 1, KV, hd), BIAS_STD)})
    return out


def torch_seed(seed: int) -> int:
    """A run's seed as a generator seed (any whole number; the generator
    takes 64 bits)."""
    return seed % (2 ** 63)


def make(cfg: dict, seed: int, device) -> dict:
    """The parameter tree on ``device`` in the config's dtype."""
    dtype = DTYPES[cfg["torch_dtype"]]
    tree: dict = {"blocks": {}}
    for name, (shape, _) in shapes(cfg).items():
        x = torch.empty(shape, dtype=dtype, device=device)
        if name.startswith("blocks."):
            tree["blocks"][name.split(".", 1)[1]] = x
        else:
            tree[name] = x
    fill(tree, cfg, seed)
    return tree


def fill(tree: dict, cfg: dict, seed: int) -> None:
    """Draw ``seed``'s weights into ``tree`` in place, leaf by leaf."""
    device = tree["embed"].device
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    for name, (_, std) in shapes(cfg).items():
        x = tree["blocks"][name.split(".", 1)[1]] if name.startswith("blocks.") \
            else tree[name]
        x.normal_(generator=gen).mul_(std)
