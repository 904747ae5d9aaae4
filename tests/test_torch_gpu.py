"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides in its body whether a Hopper card is
present and skips otherwise, so every pytest-xdist worker collects the same
tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py (f32 1e-5; bf16 2e-2 for paged
attention, 3e-2 for flash prefill; rwkv6_chunk 5e-4 in f32, 1e-3 over a chain
of chunks against the sequential oracle). TF32 is off: the plain versions'
float32 products must run in full float32.
"""
import contextlib
import os

import numpy as np
import pytest

# cuBLAS reads this when CUDA starts: deterministic algorithms (the train
# step's captured-against-eager tests) need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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


def _paged_inputs(card, B, KV, rows, hd, page, maxp, dtype, ctx, qt=1, seed=0):
    """Random q and pool, a shuffled block table; ``ctx`` None draws ragged
    contexts of at least ``qt`` tokens with ctx[0] the whole table."""
    rng = np.random.RandomState(seed)
    P = B * maxp + 2
    q = _t(rng.randn(B, KV, rows, hd), dtype, card)
    kp = _t(rng.randn(P, page, KV, hd), dtype, card)
    vp = _t(rng.randn(P, page, KV, hd), dtype, card)
    bt = torch.as_tensor(rng.permutation(P)[: B * maxp].reshape(B, maxp),
                         dtype=torch.int32, device=card)
    if ctx is None:
        ctx = rng.randint(qt, page * maxp + 1, size=(B,))
        ctx[0] = page * maxp
    return q, kp, vp, bt, torch.as_tensor(ctx, dtype=torch.int32, device=card)


# The kernel splits a context into spans of 256 tokens (16 pages of 16, 32
# of 8); the cases with explicit contexts sit on and across those borders.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,Qp,hd,page,maxp,qt,ctx", [
    (2, 2, 1, 32, 8, 4, 1, None),
    (4, 2, 3, 64, 16, 6, 1, None),
    (1, 4, 2, 128, 16, 3, 1, None),
    (3, 1, 3, 16, 16, 2, 1, None),
    (2, 2, 2, 32, 8, 4, 2, None),      # chunked queries
    (2, 2, 2, 128, 16, 5, 4, None),
    (32, 8, 2, 128, 16, 64, 1, None),  # qwen3-1.7b decode widths
    (2, 2, 2, 128, 16, 64, 1, [256, 255]),           # exactly one span
    (2, 2, 2, 128, 16, 64, 1, [257, 513]),           # one span + 1
    (4, 2, 2, 128, 16, 64, 1, [1024, 1, 1, 1]),      # longest, 1-token rows
    (3, 2, 2, 64, 16, 64, 1, [0, 1024, 700]),        # ctx 0 beside splits
    (2, 2, 3, 32, 8, 40, 1, [320, 257]),             # page 8: 32-page spans
    (3, 2, 2, 128, 16, 64, 4, [1024, 300, 257]),     # Qt 4, rows 8
    (2, 1, 4, 64, 16, 64, 8, [700, 8]),              # rows 32
    (32, 8, 3, 64, 16, 64, 1, None),   # granite-moe decode: Qp 3, pad row
    (32, 4, 8, 128, 16, 64, 1, None),  # qwen3-moe decode: Qp 8
    (3, 4, 8, 128, 16, 64, 4, [1024, 300, 257]),     # qwen3-moe, rows 32
    (32, 8, 5, 128, 16, 64, 1, None),  # qwen2.5-32b decode: Qp 5, 3 pad rows
    (32, 8, 6, 128, 16, 64, 1, None),  # internvl2-26b decode: Qp 6
    (3, 8, 5, 128, 16, 64, 4, [1024, 300, 257]),     # Qp 5, Qt 4: rows 20
    (4, 2, 7, 128, 16, 40, 1, None),   # Qp 7: a lane group's pad row
    (3, 2, 6, 128, 16, 64, 4, [1024, 300, 257]),     # Qp 6, Qt 4: rows 24
])
def test_paged_attention_kernel(card, B, KV, Qp, hd, page, maxp, qt, ctx, dtype):
    q, kp, vp, bt, cl = _paged_inputs(card, B, KV, qt * Qp, hd, page, maxp,
                                      dtype, ctx, qt)
    before = ops.launch_counts()["paged_attention"]
    out = ops.paged_attention(q, kp, vp, bt, cl, num_q_tokens=qt)
    assert ops.launch_counts()["paged_attention"] == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, cl, num_q_tokens=qt)
    _close(out, want, 1e-5 if dtype == "float32" else 2e-2)


def test_paged_attention_counters_grow_zeroed(card):
    """A call at a larger B * KV after a smaller one: the arrival counters
    grow (a new zeroed buffer) and both calls hold against the plain
    version."""
    for B, KV in ((2, 2), (48, 8)):
        args = _paged_inputs(card, B, KV, 2, 128, 16, 64, "bfloat16", None,
                             seed=B)
        out = ops.paged_attention(*args)
        _close(out, ref.paged_attention_ref(*args), 2e-2)


def test_paged_attention_back_to_back_calls_are_bit_equal(card):
    """Two calls on the same inputs give the same bits: the last block of
    each (sequence, kv slot) resets its arrival counter, so the second call
    merges exactly as the first did."""
    args = _paged_inputs(card, 8, 4, 6, 128, 16, 64, "bfloat16", None, seed=5)
    first = ops.paged_attention(*args)
    second = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
    (1, 2, 100, 2, 16, 130, True, 0, 30),   # head_dim 16, S*R = 200, offset
    (2, 1, 77, 2, 128, 77, True, 32, 0),    # S*R = 154, window
    (2, 8, 256, 2, 128, 256, True, 0, 0),   # qwen3-1.7b prefill widths
    (2, 8, 256, 3, 64, 256, True, 0, 0),    # granite-moe: R 3, hd 64
    (2, 8, 77, 3, 64, 77, True, 0, 0),      # R 3, tiles end mid-position
    (2, 4, 256, 8, 128, 256, True, 0, 0),   # qwen3-moe: R 8
    (2, 8, 256, 5, 128, 256, True, 0, 0),   # qwen2.5-32b: R 5
    (2, 8, 256, 6, 128, 256, True, 0, 0),   # internvl2-26b: R 6
    (2, 8, 77, 5, 128, 77, True, 0, 0),     # R 5, tiles end mid-position
    (2, 2, 200, 2, 128, 200, True, 0, 0),   # T not a multiple of 128 keys
    (2, 2, 200, 2, 64, 200, True, 0, 0),    # ... at head_dim 64
    (1, 2, 77, 5, 128, 77, True, 0, 0),     # S*R 385: not a multiple of 128
    (1, 2, 70, 6, 128, 70, True, 0, 0),     # S*R 420, R 6
    (1, 2, 50, 7, 64, 50, True, 0, 0),      # S*R 350, R 7
    (2, 2, 100, 5, 128, 300, True, 64, 200),  # R 5: window past an offset
    (1, 1, 4096, 5, 128, 4096, True, 0, 0),   # R 5: the ring wraps 16 times
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_reads_strided_views(card, dtype):
    """The model hands over movedim views of [B, S, G, R, hd] projections
    (float32 takes the SIMT kernel, bfloat16 the tensor-core one)."""
    rng = np.random.RandomState(3)
    q = _t(rng.randn(2, 48, 2, 2, 64), dtype, card).movedim(1, 2)
    k = _t(rng.randn(2, 48, 2, 64), dtype, card).movedim(1, 2)
    v = _t(rng.randn(2, 48, 2, 64), dtype, card).movedim(1, 2)
    assert not q.is_contiguous()
    out = ops.flash_prefill(q, k, v, causal=True)
    _close(out, ref.flash_prefill_ref(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True),
           1e-5 if dtype == "float32" else 3e-2)


def test_flash_prefill_kernel_reads_strided_views_at_r5(card):
    """The model's movedim views at R 5 and head_dim 128: the tensor maps
    over K and V step the views' own strides, Q rows end inside a
    position."""
    rng = np.random.RandomState(4)
    q = _t(rng.randn(2, 96, 4, 5, 128), "bfloat16", card).movedim(1, 2)
    k = _t(rng.randn(2, 96, 4, 128), "bfloat16", card).movedim(1, 2)
    v = _t(rng.randn(2, 96, 4, 128), "bfloat16", card).movedim(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous())
    out = ops.flash_prefill(q, k, v, causal=True)
    _close(out, ref.flash_prefill_ref(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True), 3e-2)


@pytest.mark.parametrize("kernel", ["paged_attention", "flash_prefill"])
def test_attention_kernels_bf16_output_is_rounded_once(card, kernel):
    """bf16 in, bf16 out: the kernel's result is the f32 result rounded once,
    within half a bf16 ulp (+ 2e-5 for the two f32 summation orders) of the
    plain version's f32 result on the same bf16 inputs. A tensor-core P V
    with P rounded to bf16 would break this."""
    if kernel == "paged_attention":
        args = _paged_inputs(card, 4, 8, 2, 128, 16, 64, "bfloat16",
                             [1024, 257, 1, 600], seed=9)
        out = ops.paged_attention(*args)
        want32 = ref.paged_attention_ref(*[a.float() if a.is_floating_point()
                                           else a for a in args])
    else:
        rng = np.random.RandomState(9)
        q = _t(rng.randn(2, 4, 200, 2, 128), "bfloat16", card)
        k = _t(rng.randn(2, 4, 200, 128), "bfloat16", card)
        v = _t(rng.randn(2, 4, 200, 128), "bfloat16", card)
        out = ops.flash_prefill(q, k, v, causal=True)
        want32 = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                       causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    lim = 2.0 ** -8 * want32.abs() + 2e-5
    assert bool(((out.float() - want32).abs() <= lim).all())


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
            assert not any(counts.values()), counts
    same = sum(a == b for a, b in zip(streams["dense"], streams["paged"]))
    assert same >= len(streams["dense"]) - 1


def _rwkv_inputs(card, B, c, H, K, dtype, w_dtype, seed=5, T=None):
    """Inputs as tests/test_kernels.py draws them: logw = -exp(0.5 randn),
    u = 0.1 randn, state randn. With ``T`` the r/k/v/logw tensors span T
    tokens (the model's [B, S, H, K] projections) for chunk views."""
    rng = np.random.RandomState(seed)
    T = T or c
    r, k, v = (_t(rng.randn(B, T, H, K), dtype, card) for _ in range(3))
    logw = _t(-np.exp(0.5 * rng.randn(B, T, H, K)), w_dtype, card)
    u = _t(0.1 * rng.randn(H, K), "float32", card)
    s0 = _t(rng.randn(B, H, K, K), "float32", card)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("B,c,H,K,dtype,w_dtype,out", [
    (1, 16, 64, 64, "bfloat16", "float32", "float32"),   # rwkv6-7b prefill chunk
    (1, 32, 64, 64, "bfloat16", "float32", "float32"),
    (1, 64, 64, 64, "bfloat16", "float32", "float32"),
    (2, 16, 4, 16, "float32", "float32", "float32"),     # smoke config heads
    (2, 64, 3, 32, "float32", "float32", "float32"),
    (2, 16, 8, 64, "bfloat16", "bfloat16", "float32"),
])
def test_rwkv6_chunk_kernel(card, B, c, H, K, dtype, w_dtype, out):
    args = _rwkv_inputs(card, B, c, H, K, dtype, w_dtype)
    before = ops.launch_counts()["rwkv6_chunk"]
    o, s = ops.rwkv6_chunk(*args, out_dtype=DTYPES[out])
    assert ops.launch_counts()["rwkv6_chunk"] == before + 1
    assert o.dtype == DTYPES[out] and s.dtype == torch.float32
    want_o, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=DTYPES[out])
    _close(o, want_o, 5e-4)
    _close(s, want_s, 5e-4)


def test_rwkv6_chunk_kernel_bf16_output_is_rounded_once(card):
    """o in r's dtype (bf16), as the Pallas kernel writes it: the kernel's
    f32 result rounded once to nearest, within half a bf16 ulp of the plain
    version's f32 result."""
    args = _rwkv_inputs(card, 1, 16, 64, 64, "bfloat16", "float32", seed=6)
    o16, s16 = ops.rwkv6_chunk(*args)
    o32, _ = ops.rwkv6_chunk(*args, out_dtype=torch.float32)
    assert o16.dtype == torch.bfloat16
    assert torch.equal(o16, o32.to(torch.bfloat16))
    want32, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=torch.float32)
    lim = 2.0 ** -8 * want32.abs() + 1e-3
    assert bool(((o16.float() - want32).abs() <= lim).all())
    _close(s16, want_s, 5e-4)


def test_rwkv6_chunk_kernel_reads_strided_chunk_views(card):
    """The model hands over chunk slices of its [B, S, H, K] projections."""
    r, k, v, logw, u, s0 = _rwkv_inputs(card, 4, 16, 64, 64, "bfloat16",
                                        "float32", seed=7, T=64)
    sl = slice(16, 32)
    views = [x[:, sl] for x in (r, k, v, logw)]
    assert not views[0].is_contiguous()
    o, s = ops.rwkv6_chunk(*views, u, s0, out_dtype=torch.float32)
    want_o, want_s = ref.rwkv6_chunk_plain(*[x.contiguous() for x in views],
                                           u, s0, out_dtype=torch.float32)
    _close(o, want_o, 5e-4)
    _close(s, want_s, 5e-4)


def test_rwkv6_chunk_kernel_chain_matches_sequential_oracle(card):
    r, k, v, logw, u, _ = _rwkv_inputs(card, 1, 16, 8, 64, "float32",
                                       "float32", seed=8, T=64)
    s = torch.zeros((1, 8, 64, 64), device=card)
    outs = []
    for i in range(4):
        sl = slice(16 * i, 16 * (i + 1))
        o, s = ops.rwkv6_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, s)
        outs.append(o)
    want_o, want_s = ref.rwkv6_chunk_ref(r, k, v, logw, u, torch.zeros_like(s))
    _close(torch.cat(outs, dim=1), want_o, 1e-3)
    _close(s, want_s, 1e-3)


def _rwkv_layer_inputs(card, B, S, dtype, lens=None, cut=False, seed=9):
    """One layer's call at rwkv6-7b's widths (64 heads of 64). ``lens``: row
    b's k and logw zeroed from token lens[b] on, as the model's ``valid``
    does; ``cut``: views cut from wider, longer projections."""
    r, k, v, logw, u, s0 = _rwkv_inputs(card, B, S, 64, 64, dtype, "float32",
                                        seed=seed, T=S + 32 if cut else S)
    if cut:
        def wide(x):
            w = torch.zeros(x.shape[:3] + (96,), dtype=x.dtype, device=card)
            w[..., 16:80] = x
            return w[:, 16:16 + S, :, 16:80]
        r, k, v, logw = (wide(x) for x in (r, k, v, logw))
        assert not r.is_contiguous()
    for b, n in enumerate(lens or []):
        k[b, n:] = 0
        logw[b, n:] = 0
    return r, k, v, logw, u, s0


def _chained_launches(r, k, v, logw, u, state, chunk, out_dtype):
    outs = []
    for i in range(r.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        o, state = ops.rwkv6_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u,
                                   state, out_dtype=out_dtype)
        outs.append(o)
    return torch.cat(outs, dim=1), state


# chip_smoke.py's phase-3 shapes of one layer's call
@pytest.mark.parametrize("B,S,chunk,dtype,lens,cut", [
    (1, 256, 16, "bfloat16", None, False),     # the serve's prefill
    (1, 1024, 16, "bfloat16", None, False),    # max_len
    (1, 4096, 32, "bfloat16", None, False),    # the bucket where c grows
    (2, 128, 16, "bfloat16", [128, 77], False),
    (4, 512, 16, "bfloat16", None, True),
    (1, 256, 16, "float32", None, False),
    (2, 128, 64, "float32", [128, 50], False),
    (1, 12288, 64, "bfloat16", None, False),   # 192 chunks of 64
    (1, 1008, 16, "bfloat16", [1000], False),  # S 1000 padded: 63 chunks
    (4, 256, 16, "bfloat16", None, False),     # B 4 x H 64
])
def test_rwkv6_chunk_kernel_walks_every_chunk_in_one_launch(card, B, S, chunk,
                                                            dtype, lens, cut):
    """One launch per layer against the chained plain version (the chain
    tolerance), and bit for bit against n chained one-chunk launches."""
    args = _rwkv_layer_inputs(card, B, S, dtype, lens, cut)
    f32 = torch.float32
    before = ops.launch_counts()["rwkv6_chunk"]
    o, s = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=chunk)
    assert ops.launch_counts()["rwkv6_chunk"] == before + 1
    want_o, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=f32, chunk=chunk)
    _close(o, want_o, 1e-3)
    _close(s, want_s, 1e-3)
    chain_o, chain_s = _chained_launches(*args, chunk, f32)
    torch.cuda.synchronize()
    assert torch.equal(o, chain_o) and torch.equal(s, chain_s)


def test_rwkv6_chunk_back_to_back_calls_leave_nothing_behind(card):
    """Two calls of different shapes queued back to back, then each again
    on its own: equal bit for bit, so no workspace or launch state of one
    call reaches the next."""
    f32 = torch.float32
    first = _rwkv_layer_inputs(card, 1, 256, "bfloat16", seed=11)
    second = _rwkv_layer_inputs(card, 2, 512, "bfloat16", lens=[512, 300],
                                seed=12)
    got = [ops.rwkv6_chunk(*first, out_dtype=f32, chunk=16),
           ops.rwkv6_chunk(*second, out_dtype=f32, chunk=32),
           ops.rwkv6_chunk(*first, out_dtype=f32, chunk=16)]
    torch.cuda.synchronize()
    fresh = ops.rwkv6_chunk(*second, out_dtype=f32, chunk=32)
    torch.cuda.synchronize()
    for x, y in ((got[1], fresh), (got[0], got[2])):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_rwkv6_chunk_kernel_one_launch_chain_matches_sequential_oracle(card):
    r, k, v, logw, u, _ = _rwkv_inputs(card, 1, 16, 8, 64, "float32",
                                       "float32", seed=8, T=64)
    s0 = torch.zeros((1, 8, 64, 64), device=card)
    o, s = ops.rwkv6_chunk(r, k, v, logw, u, s0, chunk=16)
    want_o, want_s = ref.rwkv6_chunk_ref(r, k, v, logw, u, s0)
    _close(o, want_o, 1e-3)
    _close(s, want_s, 1e-3)


def test_rwkv6_chunk_wrapper_refuses_what_it_does_not_take(card):
    def args(B=1, c=16, H=2, K=16, dtype=torch.float32):
        x = torch.zeros((B, c, H, K), device=card, dtype=dtype)
        return [x, x, x, x, torch.zeros((H, K), device=card),
                torch.zeros((B, H, K, K), device=card)]

    with pytest.raises(ValueError, match="dtypes"):
        ops.rwkv6_chunk(*args(dtype=torch.float16))
    a = args()
    with pytest.raises(ValueError, match="dtypes"):          # bf16 u
        ops.rwkv6_chunk(*a[:4], a[4].bfloat16(), a[5])
    with pytest.raises(ValueError, match="dtypes"):          # bf16 logw, f32 r
        ops.rwkv6_chunk(*a[:3], a[3].bfloat16(), *a[4:])
    with pytest.raises(ValueError, match="dtypes"):
        ops.rwkv6_chunk(*a, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="chunk length"):
        ops.rwkv6_chunk(*args(c=8))
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_chunk(*args(K=24))
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_chunk(*args(K=80))
    with pytest.raises(ValueError, match="do not agree"):
        ops.rwkv6_chunk(*a[:5], torch.zeros((1, 2, 16, 32), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_chunk(*a[:5], a[5].transpose(2, 3))
    x = torch.zeros((1, 16, 2, 32), device=card)[..., ::2]   # strided last dim
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_chunk(x, *a[1:])
    with pytest.raises(ValueError, match="on cpu"):
        ops.rwkv6_chunk(*a[:4], a[4].cpu(), a[5])
    long = args(c=48)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.rwkv6_chunk(*long, chunk=32)
    with pytest.raises(ValueError, match="chunk length"):
        ops.rwkv6_chunk(*long, chunk=8)
    x = torch.zeros((1, 17, 2, 16), device=card)[:, 1:]     # rows of 16 floats
    assert x.data_ptr() % 16 == 0
    y = torch.zeros((1, 16, 2, 18), device=card)[..., 2:]   # 8-byte aligned
    with pytest.raises(ValueError, match="16-byte"):
        ops.rwkv6_chunk(y, *a[1:])
    ops.rwkv6_chunk(x, *a[1:])                              # aligned: taken


def test_rwkv6_dense_engine_on_the_card_launches_its_kernel(card):
    """A smoke-config RWKV6 serve on CUDA goes through the rwkv6_chunk
    kernel, one launch per layer per prefill, serial == pipelined, and its
    streams match the plain-chunk model's (the model runs in float32)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model
    from repro_torch.serving import build_real_engine

    cfg = get_smoke_config("rwkv6-7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    trace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                        TraceConfig(num_relqueries=3, rate=100.0, seed=4,
                                    max_requests=4, output_token_cap=8),
                        tokenizer=HashTokenizer(vocab_size=cfg.vocab_size - 2))
    streams = {}
    for impl, loop in (("kernel", "serial"), ("kernel", "pipelined"),
                       ("plain", "serial")):
        tr = copy.deepcopy(trace)
        ops.reset_launch_counts()
        m = model.with_wkv_impl(impl)
        engine = build_real_engine("rwkv6-7b", "relserve", "dense", model=m,
                                   params=params, engine_loop=loop, device=card)
        engine.run_trace(tr)
        streams[impl, loop] = [tuple(r.output_tokens) for rq in tr
                               for r in rq.requests]
        counts = ops.launch_counts()
        # the executor counts its prefill steps: a graph's replay calls no
        # model function
        prefills = engine.executor.prefill_calls
        assert prefills
        # one launch per layer per prefill call, none on the plain path
        assert counts["rwkv6_chunk"] == (cfg.num_layers * prefills
                                         if impl == "kernel" else 0), counts
        assert counts["paged_attention"] == counts["flash_prefill"] == 0
    assert streams["kernel", "serial"] == streams["kernel", "pipelined"]
    plain = streams["plain", "serial"]
    same = sum(a == b for a, b in zip(streams["kernel", "serial"], plain))
    assert same >= len(plain) - 1


def test_planned_tiered_paged_engine_on_the_card(card):
    """The planned serve of chip_smoke.py phase 7 at smoke size, in float32:
    dedup fan-out and prefix-maximizing reorder in front of the paged engine
    with shared prefix blocks, a tight KV cap, preemption and swaps to the
    host tier. Both loops launch both attention kernels, give the same
    streams, and drain both pools; the planned streams match the unplanned
    serve's."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.priority import BatchLimits
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model
    from repro_torch.planner import PlanExecutor, Planner
    from repro_torch.serving import Frontend, build_real_engine

    cfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    trace = build_trace(make_dataset("rotten", num_rows=1000, seed=0),
                        TraceConfig(num_relqueries=16, rate=1e9, seed=0,
                                    max_requests=8, output_token_cap=32,
                                    dup_row_fraction=0.5), tokenizer=tok)
    cap = 3 * max(r.num_prompt_tokens + r.max_output_tokens
                  for rq in trace for r in rq.requests)

    def engine(loop):
        return build_real_engine(
            "qwen3-1.7b", "relserve", "paged", model=model, params=params,
            max_slots=64, max_len=1024, block_size=8, engine_loop=loop,
            prefix_sharing=True, kv_admission="optimistic", kv_tiering=True,
            proactive_offload=True, swap_prefetch=True,
            limits=BatchLimits(cap=cap), host_kv_cap=4 * cap,
            swap_bandwidth_gbps=8.0, device=card)

    streams = {}
    for loop in ("serial", "pipelined"):
        ops.reset_launch_counts()
        eng = engine(loop)
        planner = Planner("full", tokenizer=tok)
        planned = planner.plan_trace(copy.deepcopy(trace))
        report = PlanExecutor(Frontend(eng), planner).replay(planned)
        counts = ops.launch_counts()
        assert counts["paged_attention"] > 0 and counts["flash_prefill"] > 0
        assert len(report.latencies) == len(trace)
        assert report.deduped_requests > 0 and report.shared_kv_tokens > 0
        assert eng.executor.shared_block_hits > 0
        assert report.preemptions > 0
        assert report.swap_outs > 0 and report.swap_ins > 0
        for p in planned:
            leaders = {r.req_id: r for r in p.physical.requests}
            for lid, followers in p.fanout.items():
                for f in followers:
                    assert f.output_tokens == leaders[lid].output_tokens
        bm = eng.executor.bm
        bm.check_invariants()
        assert bm.free_blocks == bm.num_blocks
        assert bm.host_free_blocks == bm.num_host_blocks
        streams[loop] = [tuple(r.output_tokens) for p in planned
                         for r in p.logical_requests]
    assert streams["serial"] == streams["pipelined"]
    tr = copy.deepcopy(trace)
    engine("serial").run_trace(tr)
    unplanned = [tuple(r.output_tokens) for rq in tr for r in rq.requests]
    same = sum(a == b for a, b in zip(streams["serial"], unplanned))
    assert same >= len(unplanned) - 1


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"])
def test_moe_models_kernels_against_plain_on_the_card(card, arch):
    """The MoE smoke configs in float32 on CUDA: a ragged prefill through
    flash_prefill against the blockwise path, one paged decode step through
    paged_attention against the gathered-page recipe, and moe_dispatch twice
    on one batch gives the same bits (no scatter-add)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import moe_dispatch
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    B, L, bs = 3, 32, 8
    toks = torch.randint(0, cfg.vocab_size, (B, L), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lens = torch.tensor([32, 21, 5], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    lk, caches = model.with_prefill_attn("flash").prefill(
        params, toks, seq_lens=lens, max_len=L)
    lp, _ = model.with_prefill_attn("block").prefill(params, toks,
                                                     seq_lens=lens, max_len=L)
    assert ops.launch_counts()["flash_prefill"] == cfg.num_layers
    _close(lk, lp, 1e-4)
    tables = torch.arange(B * L // bs, dtype=torch.int32,
                          device=card).reshape(B, L // bs)
    pools = model.init_paged_pools(B * L // bs + 1, bs, card)
    model.scatter_prefill_pools(pools, caches, tables)
    pools_ref = {k: v.clone() for k, v in pools.items()}
    nxt = lk.argmax(-1).to(torch.int32)
    pos = torch.tensor([31, 21, 5], dtype=torch.int32, device=card)
    dk, _ = model.decode_step_paged(params, pools, nxt, pos, tables, pos + 1,
                                    attn_impl="kernel")
    dp, _ = model.decode_step_paged(params, pools_ref, nxt, pos, tables,
                                    pos + 1, attn_impl="ref")
    assert ops.launch_counts()["paged_attention"] == cfg.num_layers
    _close(dk, dp, 1e-4)
    pp = {k: v[0] for k, v in params["blocks"].items()}
    x = torch.randn((64, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(2))
    args = (x, pp["router"][0], pp["w_gate"][0], pp["w_up"][0], pp["w_down"][0])
    kw = dict(top_k=cfg.num_experts_per_tok, capacity_factor=1.25, act=cfg.act)
    a, aux_a = moe_dispatch(*args, **kw)
    b, aux_b = moe_dispatch(*args, **kw)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_paged_engine_on_the_card_matches_dense(card):
    """A granite-moe smoke serve on CUDA goes through both attention kernels
    in both loops, and its streams match the dense engine's (float32; the
    smoke config's capacity factor drops nothing)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model
    from repro_torch.serving import build_real_engine

    arch = "granite-moe-3b-a800m"
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    trace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                        TraceConfig(num_relqueries=3, rate=100.0, seed=4,
                                    max_requests=4, output_token_cap=8),
                        tokenizer=HashTokenizer(vocab_size=cfg.vocab_size - 2))
    streams = {}
    for backend, loop in (("dense", "serial"), ("paged", "serial"),
                          ("paged", "pipelined")):
        tr = copy.deepcopy(trace)
        ops.reset_launch_counts()
        engine = build_real_engine(arch, "relserve", backend, model=model,
                                   params=params, engine_loop=loop,
                                   device=card)
        engine.run_trace(tr)
        streams[backend, loop] = [tuple(r.output_tokens) for rq in tr
                                  for r in rq.requests]
        counts = ops.launch_counts()
        if backend == "paged":
            assert counts["paged_attention"] > 0 and counts["flash_prefill"] > 0
    dense = streams["dense", "serial"]
    for key in (("paged", "serial"), ("paged", "pipelined")):
        same = sum(a == b for a, b in zip(dense, streams[key]))
        assert same >= len(dense) - 1, key


@pytest.mark.parametrize("S", [1000, 12288])
def test_rwkv6_prefill_takes_chunk_lengths_the_kernel_does_not(card, S):
    """Where the reference's chunk length is not one the kernel takes (S
    1000: 8; S 12288: 96), the model runs the kernel at one it takes (padded
    for S 1000), one launch per layer, and holds the plain WKV at the
    reference's own chunking within 1e-3 of the largest value (float32,
    rwkv6 smoke config: logits and the state cache)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config("rwkv6-7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, S), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lens = torch.tensor([S, S - 123], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    lk, ck = model.with_wkv_impl("kernel").prefill(params, toks, seq_lens=lens)
    assert ops.launch_counts()["rwkv6_chunk"] == cfg.num_layers
    lp, cp = model.with_wkv_impl("plain").prefill(params, toks, seq_lens=lens)
    torch.cuda.synchronize()
    for got, want in ((lk, lp), (ck["state"], cp["state"])):
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-3, err


# ----------------------------------------------------------------------------
# the hybrid family and the training path on the card (no kernel of this repo)
# ----------------------------------------------------------------------------
def _rel(got, want):
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def test_hymba_decode_matches_reprefill_past_the_window_on_the_card(card):
    """hymba-1.5b at full width cut to 2 layers, float32: a prefill of rows of
    1100 and 1030 tokens (past the 1024-token window), then 3 decode steps,
    each against a fresh prefill of the extended rows, to 1e-5 of the
    largest logit; no kernel of this repo launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config("hymba-1.5b").replace(dtype="float32", num_layers=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    n, steps = 1100, 3
    toks = torch.randint(0, cfg.vocab_size, (2, n + steps), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lens = torch.tensor([n, n - 70], dtype=torch.int32, device=card)
    rows = torch.arange(2, device=card)
    ops.reset_launch_counts()
    _, cache = model.prefill(params, toks[:, :n], seq_lens=lens,
                             max_len=n + steps)
    for j in range(steps):
        got, cache = model.decode_step(params, cache, toks[rows, lens + j],
                                       lens + j)
        want, _ = model.prefill(params, toks[:, :n + j + 1],
                                seq_lens=lens + j + 1, max_len=n + steps)
        assert _rel(got, want) <= 1e-5, j
    assert not any(ops.launch_counts().values())


def test_full_width_train_step_on_the_card(card):
    """One train step of qwen3-1.7b at full width cut to 2 layers, float32:
    the loss and the grad norm equal the CPU's on the same weights and batch
    (1e-5 and 1e-4), so do the first moments (the clipped gradients, 1e-4 of
    each leaf's largest value; the params are not compared: a first Adam
    step moves each by lr times the sign of its gradient, which a rounding
    flips where the gradient is near 0), and no kernel of this repo
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.param_utils import tree_flatten
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = get_config("qwen3-1.7b").replace(dtype="float32", num_layers=2)
    model = build_model(cfg)
    step = make_train_step(model, TrainConfig())
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, 64))
                                 .astype(np.int32)) for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", card):
        p = {k: (v.to(dev) if torch.is_tensor(v) else
                 {kk: vv.to(dev) for kk, vv in v.items()})
             for k, v in params.items()}
        ops.reset_launch_counts()
        _, opt, m = step(p, init_opt_state(p), {k: v.to(dev)
                                                for k, v in batch.items()})
        assert not any(ops.launch_counts().values())
        out[str(torch.device(dev).type)] = (opt["m"], m)
    (mom_c, mc), (mom_g, mg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]),
                               rtol=1e-4)
    for a, b in zip(tree_flatten(mom_g)[1], tree_flatten(mom_c)[1]):
        assert _rel(a.cpu(), b) <= 1e-4


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """Params (bf16) and optimizer state (f32, the int32 step) written from
    the card and read back onto it bit for bit, each leaf on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.fault_tolerance import (load_checkpoint,
                                                         save_checkpoint)
    from repro_torch.models.param_utils import tree_flatten
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, make_train_step

    model = build_model(get_smoke_config("hymba-1.5b"))
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    batch = {k: torch.randint(0, 256, (2, 32), device=card,
                              generator=torch.Generator(device=card).manual_seed(1))
             for k in ("tokens", "labels")}
    params, opt, _ = make_train_step(model, TrainConfig(compress_grads=True))(
        params, init_opt_state(params), batch)
    trees = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 1, trees)
    step, back = load_checkpoint(str(tmp_path), template_trees=trees)
    assert step == 1
    for name in trees:
        pa, la = tree_flatten(trees[name])
        pb, lb = tree_flatten(back[name])
        assert pa == pb
        for a, b in zip(la, lb):
            assert b.device == a.device and b.dtype == a.dtype
            assert torch.equal(a, b)


def test_one_rank_nccl_mesh_on_the_card(card, tmp_path):
    """A one-rank NCCL process group and a (1, 1) ("data", "model") mesh on
    the card, at smoke size in float32: sequence-parallel decode (params and
    cache DTensors on cuda, every collective through NCCL) against the
    single-device decode_step, and the MoE model with local expert
    parallelism against moe_dispatch, to 1e-5 of the largest logit. One rank
    checks no cross-rank arithmetic (tests/test_torch_layers.py holds that on
    8 gloo ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ParallelConfig, local_tree, place_tree
    from repro_torch.models.moe import MoETransformer
    from repro_torch.models.param_utils import shard_params
    from repro_torch.models.seq_parallel import (
        SeqParallelDenseTransformer, params_from_packed, reshard_cache_from_packed)
    from repro_torch.models.transformer import DenseTransformer

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        pc = ParallelConfig.from_mesh(mesh)
        assert dist.get_backend(mesh.get_group("model")) == "nccl"
        gen = torch.Generator(device=card).manual_seed(0)
        rng = np.random.RandomState(0)
        toks = torch.as_tensor(rng.randint(0, 256, (3, 12)), dtype=torch.int32,
                               device=card)
        lens = torch.tensor([12, 7, 3], dtype=torch.int32, device=card)
        nxt = torch.as_tensor(rng.randint(0, 256, (2, 3)), dtype=torch.int32,
                              device=card)

        cfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
        base = DenseTransformer(cfg, pc)
        sp = SeqParallelDenseTransformer(cfg, pc, mesh)
        params = base.init_params(gen)
        sparams = shard_params(params_from_packed(params, base), sp.templates(),
                               pc, mesh)
        _, cache = base.prefill(params, toks, seq_lens=lens, max_len=16)
        scache = reshard_cache_from_packed(cache, base, sp)
        assert scache["k_full"].to_local().device.type == "cuda"
        for j in range(2):
            want, cache = base.decode_step(params, cache, nxt[j], lens + j)
            got, scache = sp.decode_step(sparams, scache, nxt[j], lens + j)
            got = got.full_tensor()
            assert float((got - want).abs().max() / want.abs().max()) < 1e-5

        cfg = get_smoke_config("granite-moe-3b-a800m").replace(dtype="float32")
        plain, ep = MoETransformer(cfg, pc), MoETransformer(cfg, pc)
        ep.mesh = mesh
        params = plain.init_params(gen)
        lp = local_tree(place_tree(params, mesh, ep.ep_param_specs()))
        outs = []
        for m, p in ((plain, params), (ep, lp)):
            lg, c = m.prefill(p, toks, seq_lens=lens, max_len=16)
            d, _ = m.decode_step(p, c, nxt[0], lens)
            outs.append((lg, d))
        for got, want in zip(outs[1], outs[0]):
            assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    finally:
        dist.destroy_process_group()


def test_tp_forward_on_a_one_rank_nccl_mesh(card, tmp_path):
    """The whole-model tensor-parallel forward (DTensor weights placed by
    param_specs, flash_prefill on the rank's heads, every collective through
    NCCL) against the single-device model at smoke size in float32: prefill
    and decode logits to 1e-6 of the largest, the train loss to 1e-6 and its
    gradients to 1e-5 of each leaf's largest, qwen3 and granite-moe."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.models.param_utils import shard_params, tree_flatten
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_step import loss_and_grads

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        pc = ParallelConfig.from_mesh(mesh)
        rng = np.random.RandomState(0)
        toks = torch.as_tensor(rng.randint(0, 256, (3, 16)), dtype=torch.int32,
                               device=card)
        lens = torch.tensor([16, 9, 4], dtype=torch.int32, device=card)
        nxt = torch.as_tensor(rng.randint(0, 256, (3,)), dtype=torch.int32,
                              device=card)
        batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
        for arch in ("qwen3-1.7b", "granite-moe-3b-a800m"):
            cfg = get_smoke_config(arch).replace(dtype="float32")
            single = build_model(cfg, pc).with_prefill_attn("flash")
            tp = build_model(cfg, pc).with_prefill_attn("flash")
            tp.mesh = mesh
            params = single.init_params(torch.Generator(device=card).manual_seed(0))
            dparams = shard_params(params, tp.templates(), pc, mesh)
            before = ops.launch_counts()["flash_prefill"]
            lg_t, c_t = tp.prefill(dparams, toks, seq_lens=lens, max_len=20)
            assert ops.launch_counts()["flash_prefill"] - before == cfg.num_layers
            lg_s, c_s = single.prefill(params, toks, seq_lens=lens, max_len=20)
            d_t, _ = tp.decode_step(dparams, c_t, nxt, lens)
            d_s, _ = single.decode_step(params, c_s, nxt, lens)
            for got, want in ((lg_t.full_tensor(), lg_s), (d_t.full_tensor(), d_s)):
                assert float((got - want).abs().max() / want.abs().max()) < 1e-6
            l_t, g_t = loss_and_grads(tp, dparams, batch, False)
            l_s, g_s = loss_and_grads(single, params, batch, False)
            assert abs(float(l_t) - float(l_s)) <= 1e-6 * abs(float(l_s))
            for a, b in zip(tree_flatten(g_t)[1], tree_flatten(g_s)[1]):
                a = a.full_tensor()
                assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max().clamp(min=1e-30))
    finally:
        dist.destroy_process_group()


def test_rwkv6_tp_prefill_on_a_one_rank_nccl_mesh(card, tmp_path):
    """rwkv6's tensor-parallel prefill (DTensor weights placed by
    param_specs, rwkv6_chunk on the rank's WKV heads, every collective
    through NCCL) against the single-device kernel path at smoke size in
    float32: one launch per layer, the logits and the state cache to 1e-6 of
    the largest, and a decode step after it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.models.param_utils import shard_params
    from repro_torch.models.registry import build_model

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        pc = ParallelConfig.from_mesh(mesh)
        cfg = get_smoke_config("rwkv6-7b").replace(dtype="float32")
        single, tp = build_model(cfg, pc), build_model(cfg, pc)
        tp.mesh = mesh
        params = single.init_params(torch.Generator(device=card).manual_seed(0))
        dparams = shard_params(params, tp.templates(), pc, mesh)
        rng = np.random.RandomState(0)
        toks = torch.as_tensor(rng.randint(0, 256, (3, 64)), dtype=torch.int32,
                               device=card)
        lens = torch.tensor([64, 41, 17], dtype=torch.int32, device=card)
        nxt = torch.as_tensor(rng.randint(0, 256, (3,)), dtype=torch.int32,
                              device=card)
        before = ops.launch_counts()["rwkv6_chunk"]
        lg_t, c_t = tp.prefill(dparams, toks, seq_lens=lens)
        assert ops.launch_counts()["rwkv6_chunk"] - before == cfg.num_layers
        lg_s, c_s = single.prefill(params, toks, seq_lens=lens)
        assert ops.launch_counts()["rwkv6_chunk"] - before == 2 * cfg.num_layers
        pairs = [(lg_t.full_tensor(), lg_s)] + [(c_t[k].full_tensor(), c_s[k])
                                                for k in c_s]
        d_t, _ = tp.decode_step(dparams, c_t, nxt, lens)
        d_s, _ = single.decode_step(params, c_s, nxt, lens)
        for got, want in pairs + [(d_t.full_tensor(), d_s)]:
            assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k", "train_4k"])
def test_cells_run_on_the_card_at_smoke_size(card, shape_name):
    """qwen3's three cells at smoke size (64 tokens x 4 rows), built by
    launch/cells.py, materialised on the card and run through the kernels:
    finite outputs of the cell's shapes; a prefill launches flash_prefill
    once per layer; roofline_row's bound is positive."""
    from repro_torch.configs import get_shape, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import build_cell, materialize, use_kernels
    from repro_torch.launch.roofline import roofline_row

    cfg = get_smoke_config("qwen3-1.7b")
    base = get_shape(shape_name)
    shape = ShapeConfig(base.name, base.kind, 64, 4)
    cell = use_kernels(build_cell("qwen3-1.7b", shape_name, None,
                                  cfg_override=cfg, shape=shape))
    args = materialize(cell, card)
    before = ops.launch_counts()["flash_prefill"]
    out = cell.fn(*args)
    torch.cuda.synchronize()
    launched = ops.launch_counts()["flash_prefill"] - before
    if cell.kind == "train":
        assert np.isfinite(float(out[2]["loss"])) and launched == 0
    else:
        lg = out[0]
        assert tuple(lg.shape) == (4, cfg.vocab_size)
        assert bool(torch.isfinite(lg.float()).all())
        assert launched == (cfg.num_layers if cell.kind == "prefill" else 0)
    row = roofline_row("qwen3-1.7b", shape_name, None, cfg_override=cfg, shape=shape)
    assert row["step_time_bound_s"] > 0 and row["dot_flops_per_device"] > 0


# --------------------------------------------------------------------------
# CUDA graphs of the executors' steps (engine/graphs.py) against eager steps
# (the executors' eager=True), at the smoke configs in float32
# --------------------------------------------------------------------------
GRAPH_ARCHS = [("qwen3-1.7b", "paged", "serial"),
               ("qwen3-1.7b", "paged", "pipelined"),
               ("rwkv6-7b", "dense", "serial"),
               ("hymba-1.5b", "dense", "pipelined"),
               ("granite-moe-3b-a800m", "paged", "serial")]


def _smoke(card, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init_params(torch.Generator(device=card).manual_seed(0))


def _graph_trace(cfg):
    """Every relQuery at t = 0: the batches follow from the trace alone, so
    a graphed and an eager serve serve the same batches."""
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer

    return build_trace(make_dataset("beer", num_rows=64, seed=1),
                       TraceConfig(num_relqueries=3, rate=1e9, seed=2,
                                   max_requests=3, output_token_cap=6),
                       tokenizer=HashTokenizer(vocab_size=cfg.vocab_size - 2))


def _requests(prompts, out=4):
    from repro_torch.core.relquery import make_relquery

    return make_relquery("R", [list(p) for p in prompts], 0.0, out).requests


@pytest.mark.parametrize("arch,backend,loop", GRAPH_ARCHS)
def test_graphed_serve_equals_eager(card, arch, backend, loop):
    """A serve through CUDA graphs gives the eager serve's streams and its
    launches of each kernel, once per layer per prefill call or decode step;
    every step replayed a graph."""
    import copy

    from repro_torch.serving import build_real_engine

    model, params = _smoke(card, arch)
    cfg = model.cfg
    trace = _graph_trace(cfg)
    got = {}
    for eager in (False, True):
        tr = copy.deepcopy(trace)
        ops.reset_launch_counts()
        engine = build_real_engine(arch, "relserve", backend, model=model,
                                   params=params, engine_loop=loop,
                                   device=card, eager=eager)
        engine.run_trace(tr)
        ex = engine.executor
        counts = ops.launch_counts()
        per = {"paged_attention": len(ex.decode_samples),
               "flash_prefill": ex.prefill_calls,
               "rwkv6_chunk": ex.prefill_calls}
        for name, n in counts.items():
            want = per[name] * cfg.num_layers if name in model.KERNELS else 0
            assert n == want, (name, n, want)
        assert ex.num_graphs == (0 if eager else len(ex._steps()))
        got[eager] = ([tuple(r.output_tokens) for rq in tr for r in rq.requests],
                      counts)
    assert got[False] == got[True]


def test_same_bucket_prefills_keep_their_own_logits(card):
    """Two dense prefills of one length bucket in one batch replay one
    graph twice before either is sampled: each keeps its own logits, equal
    to the eager executor's bit for bit."""
    from repro_torch.core.batch import Batch
    from repro_torch.engine.executor import RealExecutor

    model, params = _smoke(card, "qwen3-1.7b")
    prompts = [[5, 9, 17, 3, 44, 2], [70, 8, 12, 90, 1, 33, 4]]
    logits = {}
    for eager in (False, True):
        ex = RealExecutor(model, params, max_slots=4, max_len=64, eager=eager)
        reqs = _requests(prompts)
        inflight = ex.dispatch(Batch("prefill", prefill_requests=reqs), 0.0)
        logits[eager] = [lg for _, lg in inflight.prefill_pending]
        assert len(ex._prefill_fn) == 1 and ex.prefill_calls == 2
        ex.wait(inflight)
    assert not torch.equal(logits[False][0], logits[False][1])
    for g, e in zip(logits[False], logits[True]):
        assert torch.equal(g, e)


def test_capture_mid_serve_leaves_live_state_intact(card):
    """Captures while requests are live: a dense prefill bucket and (paged)
    a prefill and a decode bucket leave every live slot, and every pool
    block but the scratch page, bit for bit as they were."""
    from repro_torch.core.batch import Batch
    from repro_torch.engine.executor import PagedRealExecutor, RealExecutor

    for arch in ("rwkv6-7b", "hymba-1.5b"):
        model, params = _smoke(card, arch)
        ex = RealExecutor(model, params, max_slots=4, max_len=256)
        reqs = _requests([[5, 9, 17, 3, 44, 2], [70, 8, 12]])
        ex.execute(Batch("prefill", prefill_requests=reqs), 0.0)
        before = {k: v.clone() for k, v in ex.cache.items()}
        late = _requests([list(range(1, 100))])
        ex.prestage(Batch("prefill", prefill_requests=late))
        assert 128 in ex._prefill_fn and ex.prestage_compile_s > 0
        torch.cuda.synchronize()
        for k, v in ex.cache.items():
            assert torch.equal(v, before[k]), (arch, k)

    model, params = _smoke(card, "qwen3-1.7b")
    ex = PagedRealExecutor(model, params, num_blocks=64, block_size=8,
                           max_len=256)
    reqs = _requests([[5, 9, 17, 3, 44, 2], [70, 8, 12]])
    ex.execute(Batch("prefill", prefill_requests=reqs), 0.0)
    keep = slice(0, ex.scratch_block)
    before = {k: v[:, :, keep].clone() for k, v in ex.pools.items()}
    late = _requests([list(range(1, 100))] * 3)
    ex.prestage(Batch("prefill", prefill_requests=late))
    ex._decode_fn[(8, 4)] = ex._decode_step(8, 4)[0]
    assert (4, 128) in ex._prefill_fn
    torch.cuda.synchronize()
    for k, v in ex.pools.items():
        assert torch.equal(v[:, :, keep], before[k]), k


def test_arrival_counters_stay_put_after_capture(card):
    """The paged executor sizes the arrival counters when it is built; its
    serve (captures included) never moves them, and a capture that needs
    more than were reserved raises."""
    import copy

    from repro_torch.kernels import paged_attention
    from repro_torch.serving import build_real_engine

    model, params = _smoke(card, "qwen3-1.7b")
    engine = build_real_engine("qwen3-1.7b", "relserve", "paged", model=model,
                               params=params, device=card)
    ex = engine.executor
    buf = paged_attention.arrival_counters(ex.device, 1)
    assert buf.numel() >= ex.num_blocks * model.cache_heads
    engine.run_trace(copy.deepcopy(_graph_trace(model.cfg)))
    assert ex.num_graphs > 0
    assert paged_attention.arrival_counters(ex.device, 1).data_ptr() == buf.data_ptr()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="arrival"):
        with torch.cuda.graph(graph):
            paged_attention.arrival_counters(ex.device, buf.numel() + 1)


@pytest.mark.parametrize("B,S,H,K,c", [(1, 256, 64, 64, 16), (2, 64, 4, 16, 16),
                                       (1, 4096, 64, 64, 32)])
def test_rwkv6_chunk_replay_equals_eager(card, B, S, H, K, c):
    """rwkv6_chunk captured in a CUDA graph (the carry launched as the intra
    pass's programmatic dependent): a replay's output and state equal the
    eager call's bit for bit."""
    r, k, v, logw, u, s0 = _rwkv_inputs(card, B, S, H, K, "bfloat16",
                                        "float32", T=S)
    args = (r, k, v, logw, u, s0)
    want = ops.rwkv6_chunk(*args, out_dtype=torch.float32, chunk=c)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.rwkv6_chunk(*args, out_dtype=torch.float32, chunk=c)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = ops.rwkv6_chunk(*args, out_dtype=torch.float32, chunk=c)
    for x in got:
        x.fill_(float("nan"))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------
# the captured train step (training/train_step.py::TrainStep) and the
# captured cells (launch/cells.py::CellStep) against their eager steps,
# bit for bit under deterministic algorithms
# --------------------------------------------------------------------------
TRAIN_ARCHS = ["qwen3-1.7b", "qwen2-0.5b", "granite-moe-3b-a800m",
               "qwen3-moe-30b-a3b", "rwkv6-7b", "hymba-1.5b", "whisper-base"]
STEP_CASES = {"ga1": {}, "ga2": {"grad_accum": 2},
              "compress": {"compress_grads": True}}


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _train_setup(card, arch, layers=2):
    """The arch at full width cut to ``layers`` layers, bf16, random
    weights on the card, and a host batch of 4 rows (whisper: 64 tokens
    beside 200 frames of ragged length)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(arch).replace(num_layers=layers)
    if cfg.is_encoder_decoder:
        cfg = cfg.replace(num_encoder_layers=layers)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    rng = np.random.RandomState(1)
    batch = {k: rng.randint(0, cfg.vocab_size, size=(4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(4, 200, cfg.d_model).astype(np.float32)
        batch["frame_lens"] = np.array([200, 150, 101, 200], np.int32)
    return model, params, batch


def _same_trees(a, b):
    from repro_torch.models.param_utils import tree_flatten

    (pa, la), (pb, lb) = tree_flatten(a), tree_flatten(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y.to(x.device)), p


def _captured_vs_eager(model, tc, params, batch, steps):
    """``steps`` eager in-place steps, then as many replays of the step
    captured from the same state (its first call, the warm-up, undone by
    ``load_state``): losses, grad norms and every leaf equal bit for bit;
    no kernel of this repo launched."""
    from repro_torch.models.param_utils import tree_map
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainStep

    opt = init_opt_state(params)
    ops.reset_launch_counts()
    with _deterministic():
        eager = TrainStep(model, tc, params, opt, eager=True)
        # host copies: qwen3-moe's trees at 2 layers take 26 GB
        start = tree_map(lambda x: x.cpu(), eager.trees)
        want = [eager(batch) for _ in range(steps)]
        after = tree_map(lambda x: x.cpu(), eager.trees)
        step = TrainStep(model, tc, params, opt)
        step(batch)
        assert step.step.graph is not None and step.capture_s > 0
        step.load_state(start)
        got = [step(batch) for _ in range(steps)]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert torch.equal(g[k], w[k]), k
    _same_trees(step.trees, after)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_captured_train_step_equals_eager_bit_for_bit(card, case):
    """qwen3-1.7b at full width cut to 2 layers, bf16: three replays of the
    captured step against three eager in-place steps from the same state,
    at grad_accum 1 and 2 and with compressed gradients."""
    from repro_torch.training.train_step import TrainConfig

    model, params, batch = _train_setup(card, "qwen3-1.7b")
    _captured_vs_eager(model, TrainConfig(**STEP_CASES[case]), params, batch, 3)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_every_family_captured_train_step_equals_eager(card, arch):
    """One replay of each family's captured step (full width, 2 layers,
    bf16, remat) against one eager step from the same state."""
    from repro_torch.training.train_step import TrainConfig

    model, params, batch = _train_setup(card, arch)
    _captured_vs_eager(model, TrainConfig(), params, batch, 1)


def test_captured_train_step_resumes_through_load_state(card, tmp_path):
    """A checkpoint of the captured step's trees, read back to the host and
    copied in by ``load_state``: the next replay equals the replay from the
    live state bit for bit, and the live trees stay where they were."""
    from repro_torch.distributed.fault_tolerance import (load_checkpoint,
                                                         save_checkpoint)
    from repro_torch.models.param_utils import tree_flatten, tree_map
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, TrainStep

    model, params, batch = _train_setup(card, "qwen3-1.7b")
    with _deterministic():
        step = TrainStep(model, TrainConfig(), params, init_opt_state(params))
        for _ in range(3):
            step(batch)
        save_checkpoint(str(tmp_path), 3, step.trees)
        live = step(batch)
        after = tree_map(torch.clone, step.trees)
        where = [x.data_ptr() for x in tree_flatten(step.trees)[1]]
        _, back = load_checkpoint(str(tmp_path), template_trees=tree_map(
            lambda x: x.new_empty(0, device="cpu"), step.trees))
        step.load_state(back)
        got = step(batch)
    for k in ("loss", "grad_norm"):
        assert torch.equal(got[k], live[k]), k
    _same_trees(step.trees, after)
    assert [x.data_ptr() for x in tree_flatten(step.trees)[1]] == where


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k", "train_4k"])
def test_captured_cells_equal_eager_cells(card, shape_name):
    """qwen3-1.7b's three cells at full width cut to 2 layers (512 tokens x
    2 rows), each a CellStep captured against one called eagerly, both from
    the same materialised arguments, two steps each (the captured one's
    first is its warm-up): a prefill's logits and cache, a decode's logits
    and cache, a train cell's loss, grad norm, parameters and optimizer
    state equal bit for bit (deterministic algorithms); a prefill replay
    adds one flash_prefill launch per layer."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import (CellStep, build_cell, materialize,
                                          use_kernels)

    cfg = get_config("qwen3-1.7b").replace(num_layers=2)
    base = get_shape(shape_name)
    shape = ShapeConfig(base.name, base.kind, 512, 2)

    def made():
        cell = use_kernels(build_cell("qwen3-1.7b", shape_name, None,
                                      cfg_override=cfg, shape=shape))
        return cell, materialize(cell, card, 0)

    with _deterministic():
        cell, args = made()
        eager = CellStep(cell, args, eager=True)
        eager.step()
        want = eager.step()
        cell, cargs = made()
        cap = CellStep(cell, cargs)
        assert cap.pool is not None
        before = ops.launch_counts()["flash_prefill"]
        got = cap.step()
        launched = ops.launch_counts()["flash_prefill"] - before
    if cell.kind == "train":
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[k], want[k]), k
        _same_trees({"p": cargs[0], "o": cargs[1]}, {"p": args[0], "o": args[1]})
        assert launched == 0
        return
    assert torch.equal(got[0], want[0])
    _same_trees(got[1], want[1])
    assert launched == (cfg.num_layers if cell.kind == "prefill" else 0)


def test_train_step_whose_loss_syncs_the_host_raises_at_capture(card):
    """A loss that reads a value back to the host (a synchronising call)
    runs eagerly, its warm-up included, and raises at capture: nothing
    falls back to eager."""
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, TrainStep

    model, params, batch = _train_setup(card, "qwen3-1.7b")
    inner = model.train_loss

    def train_loss(p, b, *, remat=True):
        loss, metrics = inner(p, b, remat=remat)
        return loss * (1.0 if float(loss) >= 0 else -1.0), metrics

    model.train_loss = train_loss
    step = TrainStep(model, TrainConfig(), params, init_opt_state(params))
    with pytest.raises(RuntimeError):
        step(batch)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the host KV tier's overlapped swaps and the captured copy-on-write, at the
# smoke configs in float32 (graphed executors unless a test says otherwise)
# --------------------------------------------------------------------------
@contextlib.contextmanager
def _no_sync():
    """Any synchronising CUDA call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _ids(n, seed):
    """``n`` token ids inside the smoke configs' vocabularies."""
    return [(seed + 7 * j) % 250 + 1 for j in range(n)]


def _run_batch(ex, kind, reqs):
    """Execute one batch and append each request's token."""
    from repro_torch.core.batch import Batch

    batch = (Batch("prefill", prefill_requests=reqs) if kind == "prefill"
             else Batch("decode", decode_requests=reqs))
    _, res = ex.execute(batch, 0.0)
    for r in reqs:
        r.output_tokens.append(res.outputs[r.req_id][0])


def _kv(ex, r):
    """A copy of request ``r``'s KV: its dense slot or its paged blocks."""
    if hasattr(ex, "slots"):
        i = ex._slot_of[r.req_id]
        return {n: ex._slot_view(n, i).clone() for n in ex.cache}
    table = torch.tensor(ex.bm.block_table(r.req_id), device=ex.device)
    return {n: p.index_select(2, table) for n, p in ex.pools.items()}


def _tier_executor(card, arch, backend, eager=False):
    from repro_torch.engine.executor import make_real_executor

    model, params = _smoke(card, arch)
    return make_real_executor(backend, model, params, max_slots=2,
                              max_len=256, num_blocks=40, block_size=8,
                              num_host_blocks=64, eager=eager)


@pytest.mark.parametrize("arch,backend", [("qwen3-1.7b", "paged"),
                                          ("qwen3-1.7b", "dense"),
                                          ("rwkv6-7b", "dense")])
def test_swap_out_races_the_prefill_that_reuses_its_kv(card, arch, backend):
    """A swap-out frees a slot or blocks that the same tick's prefill writes
    while the copy to host memory is in flight: after ``wait()`` the stash,
    and after a swap-in the request's KV, equal a snapshot taken before the
    swap, bit for bit."""
    from repro_torch.core.batch import Batch

    ex = _tier_executor(card, arch, backend)
    a, = _requests([_ids(119, 1)])
    _run_batch(ex, "prefill", [a])
    before = _kv(ex, a)
    held = (ex.bm.block_table(a.req_id) if backend == "paged"
            else [ex._slot_of[a.req_id]])
    ex.swap_out(a.req_id, 0)
    b, = _requests([_ids(119, 50)])
    inflight = ex.dispatch(Batch("prefill", prefill_requests=[b]), 0.0)
    now = (ex.bm.block_table(b.req_id) if backend == "paged"
           else [ex._slot_of[b.req_id]])
    assert set(now) & set(held), "the prefill did not reuse the freed KV"
    assert a.req_id in ex._pending_host
    ex.wait(inflight)
    assert not ex._pending_host
    stash = ex._host_stash[a.req_id][-1]
    for n, x in before.items():
        assert stash[n].is_pinned() and torch.equal(stash[n], x.cpu()), n
    ex.swap_in(a.req_id, 0)
    for n, x in _kv(ex, a).items():
        assert torch.equal(x, before[n]), n


@pytest.mark.parametrize("before_wait", [True, False])
@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_prefetched_swap_in_decodes_at_once(card, backend, before_wait):
    """A request swapped out, prefetched (before its copy is materialised:
    from the device gather; or after: from pinned memory on the copy
    stream), swapped in and decoded in the very next step gives the logits
    of the same step in a run that never swapped, bit for bit, at the same
    batch shape."""
    from repro_torch.core.batch import Batch

    def logits(swap):
        ex = _tier_executor(card, "qwen3-1.7b", backend)
        a, b = _requests([_ids(119, 1), _ids(40, 90)])
        _run_batch(ex, "prefill", [a, b])
        if swap:
            ex.swap_out(a.req_id, 0)
            if before_wait:
                ex.prefetch_swap_in(a.req_id, 0)
        _run_batch(ex, "decode", [b])
        if swap:
            if not before_wait:
                ex.prefetch_swap_in(a.req_id, 0)
                staged = (ex._staged_swap_in if backend == "paged"
                          else ex._prestaged)[a.req_id]
                assert staged[1] is not None    # the copy stream's event
            ex.swap_in(a.req_id, 0)
        inflight = ex.dispatch(Batch("decode", decode_requests=[a, b]), 0.0)
        out = inflight.decode_pending.clone()
        rows = inflight.decode_rows or [0, 1]
        ex.wait(inflight)
        return out[rows]

    assert torch.equal(logits(True), logits(False))


FORCED_SWAPS = [("qwen3-1.7b", "paged", "serial"),
                ("qwen3-1.7b", "paged", "pipelined"),
                ("rwkv6-7b", "dense", "serial"),
                ("rwkv6-7b", "dense", "pipelined")]


def _forced_swap_streams(device, arch, backend, loop, force):
    """The ``_swap_roundtrip`` of tests/test_torch_engine.py at three
    requests, two of them running (``max_num_seqs``): at steps 2 and 4 the
    two running requests are swapped out, so swap-ins come back through
    prefetches. Returns the streams and the executor's hook calls."""
    import collections

    from repro_torch.core.latency_model import a100_opt13b
    from repro_torch.core.policies import SCHEDULERS
    from repro_torch.core.priority import BatchLimits
    from repro_torch.core.relquery import make_relquery
    from repro_torch.engine.engine import EngineCore
    from repro_torch.engine.executor import make_real_executor
    from repro_torch.engine.tokenizer import HashTokenizer

    model, params = _smoke(device, arch)
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size - 2)
    prompts = [tok.encode(f"row {i} of the relational table") for i in range(3)]
    rq = make_relquery("R", prompts, 0.0, 12)
    sched = SCHEDULERS["relserve"](
        limits=BatchLimits(cap=4096, max_num_seqs=2),
        latency_model=a100_opt13b(), kv_admission="optimistic",
        kv_tiering=True, host_kv_cap=100_000, swap_prefetch=True)
    ex = make_real_executor(backend, model, params, max_slots=8, max_len=256,
                            num_blocks=128, block_size=16, num_host_blocks=128)
    calls = collections.Counter()
    for hook in ("swap_out", "swap_in", "prefetch_swap_in"):
        def counted(*args, inner=getattr(ex, hook), hook=hook):
            calls[hook] += 1
            return inner(*args)
        setattr(ex, hook, counted)
    core = EngineCore(sched, ex, engine_loop=loop, debug_invariants=True)
    core.admit(rq, 0.0)
    now, steps = 0.0, 0
    while core.has_work():
        now = core.tick(now).end
        steps += 1
        if force and steps in (2, 4) and len(sched._running) >= 2:
            core._flush_plan()
            for r in list(sched._running[-2:]):
                sched.swap_out_request(r, now)
    assert rq.is_finished() and not ex._pending_host and not ex._host_stash
    return [list(r.output_tokens) for r in rq.requests], calls


@pytest.mark.parametrize("arch,backend,loop", FORCED_SWAPS)
def test_forced_swaps_keep_the_streams_on_the_card(card, arch, backend, loop):
    """Swap-outs (some swapped back in before their copy landed), swap-ins
    and prefetches through the graphed engine keep the streams of a serve
    that never swapped."""
    base, none = _forced_swap_streams(card, arch, backend, loop, False)
    swapped, calls = _forced_swap_streams(card, arch, backend, loop, True)
    assert not none and calls["swap_out"] >= 4
    assert calls["swap_in"] == calls["swap_out"] and calls["prefetch_swap_in"]
    assert swapped == base


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_swap_hooks_never_synchronise(card, backend):
    """Every swap hook on each of its paths (swap-out; prefetch from the
    device gather and from pinned memory; its cancel; swap-in after a
    prefetch, from the device gather and from pinned memory) and the
    copy-on-write step run under ``set_sync_debug_mode("error")``; the
    streams after them equal those of the same batches without swaps."""
    def run(swap):
        ex = _tier_executor(card, "qwen3-1.7b", backend)
        a, b = _requests([_ids(59, 1), _ids(40, 90)], out=16)
        _run_batch(ex, "prefill", [a, b])
        if swap:
            with _no_sync():
                ex.swap_out(a.req_id, 0)
                ex.prefetch_swap_in(a.req_id, 0)       # the device gather
                ex.cancel_swap_prefetch(a.req_id, 0)
        _run_batch(ex, "decode", [b])
        if swap:
            with _no_sync():
                ex.prefetch_swap_in(a.req_id, 0)       # the copy stream
                ex.swap_in(a.req_id, 0)
                ex.swap_out(b.req_id, 0)
        _run_batch(ex, "decode", [a])
        if swap:
            with _no_sync():
                ex.swap_in(b.req_id, 0)                # pinned memory
                ex.swap_out(a.req_id, 0)
                ex.swap_in(a.req_id, 0)                # the device gather
        if swap and backend == "paged":
            used = {x for r in (a, b) for x in ex.bm.block_table(r.req_id)}
            spare = [x for x in range(ex.num_blocks) if x not in used]
            with _no_sync():
                ex._copy_block(spare[0], spare[1])     # captures
                ex._copy_block(spare[1], spare[2])     # replays
            assert ex.cow_copies == 2 and ex._copy_fn.graph is not None
        for _ in range(3):
            _run_batch(ex, "decode", [a, b])
        return [a.output_tokens, b.output_tokens]

    assert run(True) == run(False)


def test_captured_copy_on_write_equals_eager(card):
    """The copy-on-write step, captured and replayed, writes the pools the
    eager step writes, bit for bit: one block cloned across every layer's K
    and V, every other block untouched."""
    from repro_torch.engine.executor import PagedRealExecutor

    model, params = _smoke(card, "qwen3-1.7b")
    pools = {}
    for eager in (False, True):
        ex = PagedRealExecutor(model, params, num_blocks=8, block_size=4,
                               max_len=64, eager=eager)
        gen = torch.Generator(device=card).manual_seed(3)
        for p in ex.pools.values():
            p.copy_(torch.randn(p.shape, generator=gen, device=card))
        want = {n: p.clone() for n, p in ex.pools.items()}
        for src, dst in ((2, 5), (1, 6), (5, 0)):
            for x in want.values():
                x[:, :, dst] = x[:, :, src]
            ex._copy_block(src, dst)
        assert ex.cow_copies == 3
        assert (ex._copy_fn.graph is None) == eager
        for n, p in ex.pools.items():
            assert torch.equal(p, want[n]), (eager, n)
        pools[eager] = {n: p.clone() for n, p in ex.pools.items()}
    for n in pools[False]:
        assert torch.equal(pools[False][n], pools[True][n]), n


def test_traced_serve_times_each_phase_on_the_card(card):
    """A traced paged serve on the card (``engine/trace.py``): in every
    batch the two phases' device milliseconds (CUDA events around the step
    calls) fit in the batch's tick span, and a batch with a completed
    prefill and a decode has device time in both phases."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.priority import BatchLimits
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.engine.trace import Tracer
    from repro_torch.models.registry import build_model
    from repro_torch.serving import build_real_engine

    cfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    trace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                        TraceConfig(num_relqueries=3, rate=100.0, seed=4,
                                    max_requests=4, output_token_cap=8),
                        tokenizer=HashTokenizer(vocab_size=cfg.vocab_size - 2))
    engine = build_real_engine("qwen3-1.7b", "relserve", "paged", model=model,
                               params=params, max_len=512, device=card,
                               limits=BatchLimits(cap=100_000),
                               prefix_sharing=True)
    tracer = Tracer()
    engine.core.tracer = engine.executor.tracer = tracer
    rqs = sorted(copy.deepcopy(trace), key=lambda rq: rq.arrival_time)
    now, i = 0.0, 0
    while i < len(rqs) or engine.core.has_work():
        while i < len(rqs) and rqs[i].arrival_time <= now:
            engine.core.admit(rqs[i], now)
            i += 1
        engine.core.tick(now)
        now += 0.01
    ticks = [s for s in tracer.take().spans if s.name == "tick"]
    assert ticks
    both = 0
    for t in ticks:
        pre, dec = t.attrs["device_prefill_ms"], t.attrs["device_decode_ms"]
        assert (pre or 0.0) + (dec or 0.0) <= (t.end_ns - t.start_ns) * 1e-6
        if pre is not None and t.attrs["decode"]:
            both += 1
            assert dec > 0 and pre > 0
    assert both
