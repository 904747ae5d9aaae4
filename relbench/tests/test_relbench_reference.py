"""The plain reference against the port's dense transformer at a tiny
width on the CPU in float32 (prefill, then decode through the cache), with
Qwen2.5's flags (q/k/v biases) and InternLM2's (none); and the control in
fp8 against the program in bf16 at a size a test run holds."""
import pytest
import torch

from _relbench_tiny import config
from relbench import harness, weights
from relbench.reference.model import Reference, control_gap, served_gap


def _port(cfg):
    from repro_torch.models.registry import build_model
    return build_model(harness.model_config(cfg))


def _greedy(model, params, prompts, steps, max_len):
    """The port's prefill, then its decode steps through the dense cache:
    each step's logits and the greedy tokens."""
    B, S = prompts.shape
    lg, cache = model.prefill(params, prompts, max_len=max_len)
    logits, toks = [lg], [lg.argmax(-1)]
    for i in range(steps - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        lg, cache = model.decode_step(params, cache, toks[-1].int(), pos)
        logits.append(lg)
        toks.append(lg.argmax(-1))
    return torch.stack(logits, 1), torch.stack(toks, 1)


@pytest.mark.parametrize("bias", [True, False], ids=["qwen2.5", "internlm2"])
def test_reference_equals_port_prefill_then_decode(bias):
    cfg = config("float32", bias=bias)
    params = weights.make(cfg, 11, "cpu")
    prompts = torch.randint(2, cfg["vocab_size"], (3, 21),
                            generator=torch.Generator().manual_seed(3))
    got, toks = _greedy(_port(cfg), params, prompts, 6, 32)
    seqs = [prompts[b].tolist() + toks[b, :-1].tolist() for b in range(3)]
    want = Reference(cfg, params).logits(seqs, [list(range(20, 26))] * 3)
    for b in range(3):
        torch.testing.assert_close(got[b].float(), want[b], rtol=1e-4, atol=1e-4)


def test_reference_logits_in_passes_equal_one_pass():
    cfg = config("float32")
    params = weights.make(cfg, 4, "cpu")
    sample = [{"prompt": list(range(2, 30 + 7 * i)), "served": [5, 6, 7, 8]}
              for i in range(3)]
    whole = harness.reference_logits(cfg, params, sample)
    old = harness.REFERENCE_TOKENS
    harness.REFERENCE_TOKENS = 40
    try:
        parts = harness.reference_logits(cfg, params, sample)
    finally:
        harness.REFERENCE_TOKENS = old
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# A tiny model's readings: the port in bf16 reads at most 0.0185 on seeds
# 1-8, the fp8 control at least 0.14. The limit at this size lies between.
TINY_LIMIT = 0.06


@pytest.mark.parametrize("seed", [1, 4])
def test_fp8_control_fails_where_the_bf16_program_passes(seed):
    cfg = dict(config("bfloat16"), hidden_size=256, intermediate_size=512,
               head_dim=64, num_hidden_layers=4, vocab_size=4096)
    params = weights.make(cfg, seed, "cpu")
    prompts = torch.randint(2, cfg["vocab_size"], (4, 40),
                            generator=torch.Generator().manual_seed(seed))
    _, toks = _greedy(_port(cfg), params, prompts, 16, 64)
    sample = [{"prompt": prompts[b].tolist(), "served": toks[b].tolist()}
              for b in range(4)]
    f32 = harness.reference_logits(cfg, params, sample)
    fp8 = harness.reference_logits(cfg, params, sample, quant="fp8")
    program = max(served_gap(a, s["served"]) for a, s in zip(f32, sample))
    control = max(control_gap(a, b) for a, b in zip(f32, fp8))
    assert program <= TINY_LIMIT < control, (program, control)
