"""relbench/flops.py against counts by hand at a small shape."""
import pytest

from relbench import flops

# D 8, 4 query heads and 2 kv heads of 2, F 16, V 10, 3 layers
D = {"L": 3, "D": 8, "H": 4, "KV": 2, "Qp": 2, "hd": 2, "F": 16, "V": 10}


def test_layer_params():
    # q 8x8, k and v 8x4 each, o 8x8, gate/up/down 8x16 each
    assert flops.layer_params(D) == 64 + 32 + 32 + 64 + 3 * 128


def test_flash_prefill_call():
    # rows of 3 and 1 tokens: 6 + 1 causal pairs; QK^T and PV: 2 * 2 * H * hd
    w = flops.flash_prefill_call(D, [3, 1])
    assert w["flops"] == 4 * 4 * 2 * 7
    # q and o: 4 heads x 2; k and v: 2 heads x 2; bf16; 4 tokens
    assert w["bytes"] == 4 * (2 * 8 + 2 * 4) * 2


def test_paged_attention_call():
    w = flops.paged_attention_call(D, [5, 2])
    assert w["flops"] == 4 * 4 * 2 * 7
    # per row q and o once (2 x 8 values), K and V of its context (2 x c x 4)
    assert w["bytes"] == (2 * 8 * 2) * 2 + 2 * 7 * 4 * 2


def test_prefill_and_decode_model_flops():
    per_tok = 2 * flops.layer_params(D) * 3
    head = 2 * 8 * 10
    assert flops.prefill_flops(D, [3, 1]) == per_tok * 4 + 3 * 4 * 4 * 2 * 7 + 2 * head
    assert flops.decode_flops(D, [5, 2]) == (per_tok + head) * 2 + 3 * 4 * 4 * 2 * 7


def test_bound_is_the_slower_roof():
    assert flops.bound_s({"flops": flops.PEAK_FLOPS, "bytes": 0.0}) == pytest.approx(1.0)
    assert flops.bound_s({"flops": 0.0, "bytes": flops.HBM_BW * 2}) == pytest.approx(2.0)
