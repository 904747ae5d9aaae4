"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides in its body whether a Hopper card is
present and skips otherwise, so every pytest-xdist worker collects the same
tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py (f32 1e-5; bf16 2e-2 for paged
attention, 3e-2 for flash prefill). TF32 is off: the plain versions' float32
products must run in full float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (CUDA capability >= 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(x, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, DTYPES[dtype])


def _close(out, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,Qp,hd,page,maxp,qt", [
    (2, 2, 1, 32, 8, 4, 1),
    (4, 2, 3, 64, 16, 6, 1),
    (1, 4, 2, 128, 16, 3, 1),
    (3, 1, 3, 16, 16, 2, 1),
    (2, 2, 2, 32, 8, 4, 2),      # chunked queries
    (2, 2, 2, 128, 16, 5, 4),
    (32, 8, 2, 128, 16, 64, 1),  # qwen3-1.7b decode widths
])
def test_paged_attention_kernel(card, B, KV, Qp, hd, page, maxp, qt, dtype):
    rng = np.random.RandomState(0)
    P = B * maxp + 2
    q = _t(rng.randn(B, KV, qt * Qp, hd), dtype, card)
    kp = _t(rng.randn(P, page, KV, hd), dtype, card)
    vp = _t(rng.randn(P, page, KV, hd), dtype, card)
    bt = torch.as_tensor(rng.permutation(P)[: B * maxp].reshape(B, maxp),
                         dtype=torch.int32, device=card)
    ctx = rng.randint(qt, page * maxp + 1, size=(B,))
    ctx[0] = page * maxp
    cl = torch.as_tensor(ctx, dtype=torch.int32, device=card)
    before = ops.launch_counts()["paged_attention"]
    out = ops.paged_attention(q, kp, vp, bt, cl, num_q_tokens=qt)
    assert ops.launch_counts()["paged_attention"] == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, cl, num_q_tokens=qt)
    _close(out, want, 1e-5 if dtype == "float32" else 2e-2)


def test_paged_attention_kernel_zero_context(card):
    rng = np.random.RandomState(1)
    q = _t(rng.randn(2, 2, 2, 32), "float32", card)
    kp = _t(rng.randn(5, 8, 2, 32), "float32", card)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=card)
    cl = torch.as_tensor([0, 5], dtype=torch.int32, device=card)
    out = ops.paged_attention(q, kp, kp, bt, cl)
    assert torch.count_nonzero(out[0]) == 0
    _close(out, ref.paged_attention_ref(q, kp, kp, bt, cl), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,G,S,R,hd,T,causal,window,qoff", [
    (2, 2, 64, 2, 32, 64, True, 0, 0),
    (1, 3, 128, 1, 64, 128, True, 0, 0),
    (2, 2, 64, 2, 32, 64, True, 16, 0),     # sliding window
    (1, 2, 32, 3, 64, 96, True, 0, 64),     # prefix-cache offset
    (2, 1, 64, 1, 32, 64, False, 0, 0),     # non-causal
    (1, 2, 40, 3, 16, 40, True, 0, 0),      # ragged tiles, head_dim 16
    (2, 8, 256, 2, 128, 256, True, 0, 0),   # qwen3-1.7b prefill widths
])
def test_flash_prefill_kernel(card, B, G, S, R, hd, T, causal, window, qoff,
                              dtype):
    rng = np.random.RandomState(2)
    q = _t(rng.randn(B, G, S, R, hd), dtype, card)
    k = _t(rng.randn(B, G, T, hd), dtype, card)
    v = _t(rng.randn(B, G, T, hd), dtype, card)
    before = ops.launch_counts()["flash_prefill"]
    out = ops.flash_prefill(q, k, v, causal=causal, window=window, q_offset=qoff)
    assert ops.launch_counts()["flash_prefill"] == before + 1
    want = ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                 q_offset=qoff)
    _close(out, want, 1e-5 if dtype == "float32" else 3e-2)


def test_flash_prefill_kernel_reads_strided_views(card):
    """The model hands over movedim views of [B, S, G, R, hd] projections."""
    rng = np.random.RandomState(3)
    q = _t(rng.randn(2, 48, 2, 2, 64), "float32", card).movedim(1, 2)
    k = _t(rng.randn(2, 48, 2, 64), "float32", card).movedim(1, 2)
    assert not q.is_contiguous()
    out = ops.flash_prefill(q, k, k, causal=True)
    _close(out, ref.flash_prefill_ref(q.contiguous(), k.contiguous(),
                                      k.contiguous(), causal=True), 1e-5)


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 2, 2, 48), device=card)          # head_dim 48
    kp = torch.zeros((3, 8, 2, 48), device=card)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=card)
    cl = torch.ones((1,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q, kp, kp, bt, cl)
    qf = torch.zeros((1, 1, 16, 1, 32), device=card, dtype=torch.float16)
    kf = torch.zeros((1, 1, 16, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_prefill(qf, kf, kf)


def test_paged_engine_on_the_card_launches_both_kernels(card):
    """A smoke-config serve on CUDA goes through both kernels, and its
    streams match the dense engine's (the model runs in float32)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model
    from repro_torch.serving import build_real_engine

    cfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    trace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                        TraceConfig(num_relqueries=3, rate=100.0, seed=4,
                                    max_requests=4, output_token_cap=8),
                        tokenizer=HashTokenizer(vocab_size=cfg.vocab_size - 2))
    streams = {}
    for backend in ("dense", "paged"):
        tr = copy.deepcopy(trace)
        ops.reset_launch_counts()
        engine = build_real_engine("qwen3-1.7b", "relserve", backend,
                                   model=model, params=params, device=card)
        engine.run_trace(tr)
        streams[backend] = [tuple(r.output_tokens) for rq in tr for r in rq.requests]
        counts = ops.launch_counts()
        if backend == "paged":
            assert counts["paged_attention"] > 0 and counts["flash_prefill"] > 0
        else:
            assert counts == {"paged_attention": 0, "flash_prefill": 0}
    same = sum(a == b for a, b in zip(streams["dense"], streams["paged"]))
    assert same >= len(streams["dense"]) - 1
