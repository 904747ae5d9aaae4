"""The port's plain kernels (``repro_torch.kernels.ref``) against the JAX
package's Pallas kernels (interpret mode, as tests/test_kernels.py runs them)
and the JAX oracles, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: 1e-5 in float32, 2e-2 for
paged attention and 3e-2 for flash prefill in bfloat16. Contexts are >= 1
token except in the test that pins the ``ctx == 0`` convention, where the
port follows the Pallas kernel (zeros), not the JAX oracle (mean of V).

``rwkv6_chunk_plain`` (what the CUDA kernel is held to on the card) is held
to the Pallas ``rwkv6_chunk`` and the model's ``wkv6_chunk`` in float32 to
1e-5 of the largest value: the two frameworks order the cumulative log-decay
sums differently, and ``exp`` of a sum of up to 64 terms carries that
rounding into every output, so at c = 64 both sides lie ~1e-4 (absolute, on
outputs up to ~70) from the float64 result. Against the sequential oracle
to 5e-4, and over a 4-chunk chain to 1e-3, the tolerances of
tests/test_kernels.py.

The end of the file holds the analysis tooling's traced cells: dot FLOPs
against the reference's HLO dots, the small-mesh dry run, the composed
peak against a trace of every layer (within 2%, equal for decode), its
independence of what the process traced before, and the roofline row's
keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged_attention  # noqa: E402
from repro.kernels.ref import flash_prefill_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
from repro.kernels.ref import rwkv6_chunk_ref as jax_chunk_ref  # noqa: E402
from repro.kernels.rwkv6_chunk import rwkv6_chunk as jax_pallas_chunk  # noqa: E402
from repro.models.rwkv6 import wkv6_chunk as jax_wkv6_chunk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same values in both frameworks (f32 -> bf16 rounds to nearest
    even in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(out_t, want_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


def _paged_case(B, KV, rows, hd, page, maxp, dtype, seed, ctx=None):
    rng = np.random.RandomState(seed)
    P = B * maxp + 2
    q = rng.randn(B, KV, rows, hd).astype(np.float32)
    kp = rng.randn(P, page, KV, hd).astype(np.float32)
    vp = rng.randn(P, page, KV, hd).astype(np.float32)
    bt = rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32)
    cl = (rng.randint(1, page * maxp + 1, size=(B,)) if ctx is None
          else np.asarray(ctx)).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, kp, vp))
    return ((qj, kj, vj, jnp.asarray(bt), jnp.asarray(cl)),
            (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(cl)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,Qp,hd,page,maxp", [
    (2, 2, 1, 32, 8, 4),
    (4, 2, 3, 64, 16, 6),
    (1, 4, 2, 128, 16, 3),
    (2, 2, 5, 128, 16, 3),                  # qwen2.5-32b's 5 q rows per slot
    (1, 2, 6, 128, 16, 4),                  # internvl2-26b's 6
    (2, 1, 8, 128, 16, 3),                  # qwen3-moe-30b-a3b's 8
])
def test_paged_attention_ref_matches_jax(B, KV, Qp, hd, page, maxp, dtype):
    jargs, targs = _paged_case(B, KV, Qp, hd, page, maxp, dtype, seed=0)
    out = ref.paged_attention_ref(*targs)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(out, jax_paged_attention(*jargs, interpret=True), tol)
    _close(out, jax_paged_ref(*jargs), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_q_tokens", [2, 4])
def test_paged_attention_ref_chunked_queries(dtype, num_q_tokens):
    """Chunk mode (test_paged_parity.py's cases): Qt query tokens per
    sequence, token t at position ctx - Qt + t."""
    B, KV, Qp, hd, page, maxp = 2, 2, 2, 32, 8, 4
    jargs, targs = _paged_case(B, KV, num_q_tokens * Qp, hd, page, maxp, dtype,
                               seed=3, ctx=[page * 2 + 5, page * 4])
    out = ref.paged_attention_ref(*targs, num_q_tokens=num_q_tokens)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(out, jax_paged_attention(*jargs, interpret=True,
                                    num_q_tokens=num_q_tokens), tol)
    _close(out, jax_paged_ref(*jargs, num_q_tokens=num_q_tokens), tol)


def test_paged_attention_ref_zero_context_follows_the_kernel():
    jargs, targs = _paged_case(3, 2, 2, 32, 8, 3, "float32", seed=5,
                               ctx=[0, 9, 24])
    out = ref.paged_attention_ref(*targs)
    assert torch.count_nonzero(out[0]) == 0
    _close(out, jax_paged_attention(*jargs, interpret=True), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,G,S,R,hd,T,causal,window,qoff", [
    (2, 2, 64, 2, 32, 64, True, 0, 0),
    (1, 3, 128, 1, 64, 128, True, 0, 0),
    (2, 2, 64, 2, 32, 64, True, 16, 0),     # sliding window
    (1, 2, 32, 3, 64, 96, True, 0, 64),     # prefix-cache offset
    (2, 1, 64, 1, 32, 64, False, 0, 0),     # non-causal
    (1, 2, 64, 5, 128, 64, True, 0, 0),     # qwen2.5-32b's R = 5
    (1, 1, 96, 6, 128, 96, True, 0, 0),     # internvl2-26b's R = 6
    (1, 1, 64, 8, 128, 64, True, 0, 0),     # qwen3-moe-30b-a3b's R = 8
])
def test_flash_prefill_ref_matches_jax(B, G, S, R, hd, T, causal, window, qoff,
                                       dtype):
    rng = np.random.RandomState(7)
    q = rng.randn(B, G, S, R, hd).astype(np.float32)
    k = rng.randn(B, G, T, hd).astype(np.float32)
    v = rng.randn(B, G, T, hd).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    out = ref.flash_prefill_ref(qt, kt, vt, causal=causal, window=window,
                                q_offset=qoff)
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close(out, jax_flash_prefill(qj, kj, vj, causal=causal, window=window,
                                  q_offset=qoff, q_block=32, kv_block=32,
                                  interpret=True), tol)
    _close(out, jax_flash_ref(qj, kj, vj, causal=causal, window=window,
                              q_offset=qoff), tol)


def test_ops_dispatch_cpu_tensors_to_the_plain_path():
    """On CPU tensors ``ops`` runs the plain versions (bit-identical to
    calling them) and no kernel launch is counted."""
    ops.reset_launch_counts()
    _, targs = _paged_case(2, 2, 2, 32, 8, 4, "float32", seed=1)
    assert torch.equal(ops.paged_attention(*targs),
                       ref.paged_attention_ref(*targs))
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 2, 32, 2, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 32, 32).astype(np.float32))
    assert torch.equal(ops.flash_prefill(q, k, k, causal=True, window=8),
                       ref.flash_prefill_ref(q, k, k, causal=True, window=8))
    assert ops.launch_counts() == {"paged_attention": 0, "flash_prefill": 0,
                                   "rwkv6_chunk": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error there."""
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    _, targs = _paged_case(1, 2, 2, 32, 8, 2, "float32", seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*targs)
    q = torch.zeros(1, 1, 16, 1, 32)
    k = torch.zeros(1, 1, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_cuda(q, k, k)
    from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk_cuda

    r = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_chunk_cuda(r, r, r, r, torch.zeros(2, 16),
                         torch.zeros(1, 2, 16, 16))


# ----------------------------------------------------------------------------
# rwkv6_chunk
# ----------------------------------------------------------------------------
def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dtype)


def _close_rel(out_t, want_j, tol):
    """Max abs difference within ``tol`` of the largest |value|."""
    want = np.asarray(want_j, np.float32)
    err = float(np.abs(out_t.float().numpy() - want).max())
    assert err <= tol * (float(np.abs(want).max()) or 1.0)


def _chunk_inputs(B, c, H, K, seed=0):
    """Inputs as tests/test_kernels.py draws them, from numpy."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, c, H, K).astype(np.float32) for _ in range(3))
    logw = -np.exp(0.5 * rng.randn(B, c, H, K)).astype(np.float32)
    u = (0.1 * rng.randn(H, K)).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("B,c,H,K", [(2, 16, 2, 16), (1, 32, 4, 32), (2, 64, 2, 64)])
def test_rwkv6_plain_chunk_matches_pallas_model_and_oracle(B, c, H, K):
    args = _chunk_inputs(B, c, H, K)
    o, s = ref.rwkv6_chunk_plain(*map(_t, args))
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    for jo, js in (jax_pallas_chunk(*jargs, interpret=True),
                   jax_wkv6_chunk(*jargs)):
        _close_rel(o, jo, 1e-5)
        _close_rel(s, js, 1e-5)
    o_seq, s_seq = ref.rwkv6_chunk_ref(*map(_t, args))
    _close(o, o_seq.numpy(), 5e-4)
    _close(s, s_seq.numpy(), 5e-4)


def test_rwkv6_sequential_oracle_matches_jax_oracle():
    args = _chunk_inputs(2, 16, 2, 16, seed=1)
    o, s = ref.rwkv6_chunk_ref(*map(_t, args))
    jo, js = jax_chunk_ref(*[jnp.asarray(a) for a in args])
    _close(o, jo, 1e-5)
    _close(s, js, 1e-5)


def test_rwkv6_plain_chunk_mixed_dtypes():
    """bf16 r/k/v with f32 logw, as the model's bf16 prefill hands them over:
    ``o`` comes back in r's dtype by default (as the Pallas kernel writes it)
    or in float32 on request (as the model keeps it)."""
    r, k, v, logw, u, s0 = _chunk_inputs(2, 16, 2, 16, seed=2)
    bf = [_t(x, torch.bfloat16) for x in (r, k, v)]
    rest = [_t(logw), _t(u), _t(s0)]
    o16, s16 = ref.rwkv6_chunk_plain(*bf, *rest)
    o32, s32 = ref.rwkv6_chunk_plain(*bf, *rest, out_dtype=torch.float32)
    assert o16.dtype == torch.bfloat16 and o32.dtype == torch.float32
    assert s16.dtype == torch.float32
    jbf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    jrest = [jnp.asarray(x) for x in (logw, u, s0)]
    # the model's wkv6_chunk on the same bf16 inputs returns f32
    jo, js = jax_wkv6_chunk(*jbf, *jrest)
    assert jo.dtype == jnp.float32
    _close_rel(o32, jo, 1e-5)
    _close_rel(s32, js, 1e-5)
    torch.testing.assert_close(o16, o32.to(torch.bfloat16), atol=0, rtol=0)
    # the Pallas kernel writes o in r's dtype
    po, ps = jax_pallas_chunk(*jbf, *jrest, interpret=True)
    assert po.dtype == jnp.bfloat16
    _close(o16, po, 2e-2)
    _close_rel(s16, ps, 1e-5)


def test_rwkv6_chunk_chain_matches_long_recurrence():
    """Chaining the plain chunk across a sequence == one long recurrence, and
    == the Pallas chunk chained the same way."""
    B, c, H, K, n = 1, 16, 2, 16, 4
    r, k, v, logw, u, _ = _chunk_inputs(B, c * n, H, K, seed=3)
    s = torch.zeros((B, H, K, K))
    js = jnp.zeros((B, H, K, K))
    outs, jouts = [], []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        o, s = ref.rwkv6_chunk_plain(_t(r[:, sl]), _t(k[:, sl]), _t(v[:, sl]),
                                     _t(logw[:, sl]), _t(u), s)
        outs.append(o)
        jo, js = jax_pallas_chunk(*[jnp.asarray(x[:, sl]) for x in (r, k, v, logw)],
                                  jnp.asarray(u), js, interpret=True)
        jouts.append(jo)
    o_all = torch.cat(outs, dim=1)
    o_seq, s_seq = ref.rwkv6_chunk_ref(_t(r), _t(k), _t(v), _t(logw), _t(u),
                                       torch.zeros((B, H, K, K)))
    _close(o_all, o_seq.numpy(), 1e-3)
    _close(s, s_seq.numpy(), 1e-3)
    _close_rel(o_all, jnp.concatenate(jouts, axis=1), 1e-5)
    _close_rel(s, js, 1e-5)


def test_rwkv6_ops_dispatch_runs_plain_on_cpu_and_counts_nothing():
    args = [_t(a) for a in _chunk_inputs(1, 16, 2, 16, seed=4)]
    before = ops.launch_counts()
    o, s = ops.rwkv6_chunk(*args, out_dtype=torch.float32)
    want_o, want_s = ref.rwkv6_chunk_plain(*args)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    o, s = ops.rwkv6_chunk(*args, out_dtype=torch.float32, chunk=8)
    want_o, want_s = ref.rwkv6_chunk_plain(*args, chunk=8)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    assert ops.launch_counts() == before


def _padded(args, lens):
    """Row b's k and logw zeroed from token lens[b] on, as the model's
    ``valid`` mask does for pad tokens."""
    r, k, v, logw, u, s0 = (np.array(a) for a in args)
    for b, n in enumerate(lens):
        k[b, n:] = 0.0
        logw[b, n:] = 0.0
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("padded", [False, True])
def test_rwkv6_plain_chunked_equals_loop_of_one_chunk_calls(c, n, padded):
    """One chunked call == the loop of one-chunk calls that the model used to
    make, bit for bit: o, its bf16 rounding and the carried state."""
    B, H, K, S = 2, 2, 16, c * n
    args = _chunk_inputs(B, S, H, K, seed=10 + n)
    if padded:
        args = _padded(args, [S, S - c // 2 - 3])
    r, k, v, logw, u, s0 = map(_t, args)
    for out_dtype in (torch.float32, torch.bfloat16):
        o, s = ref.rwkv6_chunk_plain(r, k, v, logw, u, s0, out_dtype=out_dtype,
                                     chunk=c)
        st, outs = s0, []
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            oi, st = ref.rwkv6_chunk_plain(r[:, sl], k[:, sl], v[:, sl],
                                           logw[:, sl], u, st,
                                           out_dtype=out_dtype)
            outs.append(oi)
        assert o.dtype == out_dtype and tuple(o.shape) == (B, S, H, K)
        assert torch.equal(o, torch.cat(outs, dim=1))
        assert torch.equal(s, st)


@pytest.mark.parametrize("B,c,n,H,K,padded", [
    (1, 16, 4, 2, 16, False),
    (2, 32, 2, 2, 32, True),
    (1, 64, 2, 1, 64, False),
])
def test_rwkv6_plain_chunked_matches_loops_of_pallas_and_model_chunks(
        B, c, n, H, K, padded):
    """The chunked plain call against loops of the Pallas kernel (interpret
    mode) and of the model's ``wkv6_chunk``, chunk by chunk, to 1e-5 of the
    largest value, as the one-chunk test holds them."""
    S = c * n
    args = _chunk_inputs(B, S, H, K, seed=20 + c)
    if padded:
        args = _padded(args, [S, S - c - 5])
    r, k, v, logw, u, s0 = args
    o, s = ref.rwkv6_chunk_plain(*map(_t, args), chunk=c)
    for fn in (lambda *a: jax_pallas_chunk(*a, interpret=True), jax_wkv6_chunk):
        js, jouts = jnp.asarray(s0), []
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            jo, js = fn(*[jnp.asarray(x[:, sl]) for x in (r, k, v, logw)],
                        jnp.asarray(u), js)
            jouts.append(jo)
        _close_rel(o, jnp.concatenate(jouts, axis=1), 1e-5)
        _close_rel(s, js, 1e-5)


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("B", [1, 3])
def test_rwkv6_split_emulation_equals_the_plain_chunks_bit_for_bit(c, n, B):
    """The CUDA kernel's split (every chunk's own terms, then the state carry,
    then the outputs) computes what the plain chunk loop computes, bit for
    bit: o in float32 (and bf16 below 16 chunks) and the carried state;
    masked rows too."""
    H, K, S = 2, 16, c * n
    args = _chunk_inputs(B, S, H, K, seed=30 + n + B)
    args = _padded(args, [S, S - c // 2 - 3, max(1, S // 3)][:B])
    r, k, v, logw, u, s0 = map(_t, args)
    for out_dtype in (torch.float32, torch.bfloat16)[:1 if n == 16 else 2]:
        o, s = ref.rwkv6_chunk_split_emulation(r, k, v, logw, u, s0,
                                               out_dtype=out_dtype, chunk=c)
        want_o, want_s = ref.rwkv6_chunk_plain(r, k, v, logw, u, s0,
                                               out_dtype=out_dtype, chunk=c)
        assert o.dtype == out_dtype and s.dtype == torch.float32
        assert torch.equal(o, want_o) and torch.equal(s, want_s)


@pytest.mark.parametrize("B,c,n,H,K,padded", [
    (1, 16, 3, 2, 16, False),
    (3, 32, 2, 2, 32, True),
    (1, 64, 2, 1, 64, True),
])
def test_rwkv6_split_emulation_matches_loops_of_the_pallas_kernel(
        B, c, n, H, K, padded):
    """The split against the Pallas kernel (interpret mode) chained chunk by
    chunk, at the chain loops' tolerance (1e-5 of the largest value)."""
    S = c * n
    args = _chunk_inputs(B, S, H, K, seed=40 + c)
    if padded:
        args = _padded(args, [S, S - c - 5, S // 2][:B])
    r, k, v, logw, u, s0 = args
    o, s = ref.rwkv6_chunk_split_emulation(*map(_t, args), chunk=c)
    js, jouts = jnp.asarray(s0), []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        jo, js = jax_pallas_chunk(*[jnp.asarray(x[:, sl]) for x in (r, k, v, logw)],
                                  jnp.asarray(u), js, interpret=True)
        jouts.append(jo)
    _close_rel(o, jnp.concatenate(jouts, axis=1), 1e-5)
    _close_rel(s, js, 1e-5)


@pytest.mark.parametrize("S,chunk", [(48, 32), (16, 64), (40, 16)])
def test_rwkv6_ops_refuses_a_chunk_that_does_not_divide_the_sequence(S, chunk):
    args = [_t(a) for a in _chunk_inputs(1, S, 2, 16, seed=5)]
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.rwkv6_chunk(*args, chunk=chunk)


# ----------------------------------------------------------------------------
# the CUDA kernels' own arithmetic, rehearsed on the CPU
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("max_pages,page,plan", [
    (64, 16, (16, 4)),      # the serve's pool: 256-token spans
    (4, 8, (32, 1)),
    (40, 8, (32, 2)),
    (3, 512, (1, 3)),       # pages longer than a span: one page each
    (0, 16, (16, 1)),       # an empty table still launches one split
])
def test_paged_attention_split_plan(max_pages, page, plan):
    from repro_torch.kernels.paged_attention import split_plan

    assert split_plan(max_pages, page) == plan
    pps, n_split = plan
    assert n_split * pps >= max_pages and (n_split - 1) * pps < max(max_pages, 1)


def test_paged_attention_split_plan_refuses_bad_geometry():
    from repro_torch.kernels.paged_attention import split_plan

    with pytest.raises(ValueError):
        split_plan(4, 0)
    with pytest.raises(ValueError):
        split_plan(-1, 16)


@pytest.mark.parametrize("B,KV,Qp,hd,page,maxp,qt,pps,ctx", [
    (3, 2, 2, 32, 8, 6, 1, 2, [0, 48, 17]),        # ctx 0; row 2: split 2 empty
    (2, 2, 1, 64, 8, 6, 1, 2, [16, 33]),           # exactly one span; span + 1
    (2, 2, 2, 32, 8, 6, 4, 2, [34, 9]),            # Qt 4: split 2 holds no key
                                                   # that tokens 0-1 may see
    (2, 1, 3, 16, 16, 5, 1, 1, [80, 1]),           # one page per split
    (2, 2, 2, 32, 8, 4, 1, None, [32, 5]),         # the wrapper's plan: 1 split
    (2, 2, 5, 128, 16, 40, 1, None, [600, 257]),   # Qp 5: 3 splits, the last
                                                   # block's merge in split order
    (1, 2, 6, 128, 16, 40, 1, None, [640]),        # Qp 6: every split full
    (2, 1, 7, 128, 8, 64, 1, None, [500, 256]),    # Qp 7, page 8: 2 splits
])
def test_paged_attention_split_ref_matches_oracles(B, KV, Qp, hd, page, maxp,
                                                   qt, pps, ctx):
    """Per-split partials merged by log-sum-exp == the one-pass softmax, in
    float32 to 1e-5: against the port's ``paged_attention_ref`` and the JAX
    Pallas kernel (interpret mode)."""
    jargs, targs = _paged_case(B, KV, qt * Qp, hd, page, maxp, "float32",
                               seed=11, ctx=ctx)
    out = ref.paged_attention_split_ref(*targs, num_q_tokens=qt,
                                        pages_per_split=pps)
    assert torch.isfinite(out).all()
    assert torch.count_nonzero(out[np.asarray(ctx) == 0]) == 0
    _close(out, ref.paged_attention_ref(*targs, num_q_tokens=qt).numpy(), 1e-5)
    _close(out, jax_paged_attention(*jargs, interpret=True,
                                    num_q_tokens=qt), 1e-5)


@pytest.mark.parametrize("B,G,S,R,hd,T,causal,window,qoff", [
    (2, 2, 100, 2, 128, 100, True, 0, 0),   # 200 packed rows, ragged tiles
    (1, 2, 64, 2, 64, 64, True, 16, 0),     # sliding window
    (1, 1, 48, 3, 16, 112, True, 0, 64),    # head_dim 16, prefix offset
    (1, 2, 70, 1, 32, 70, False, 0, 0),     # non-causal
    (1, 1, 160, 5, 64, 160, True, 0, 0),    # R 5: 64-row groups end inside
    (1, 1, 160, 5, 128, 160, True, 0, 0),   # a position; two 128-key tiles
    (1, 1, 150, 6, 64, 150, True, 0, 0),    # R 6
    (1, 1, 150, 6, 128, 150, True, 0, 0),
    (1, 1, 140, 8, 64, 140, True, 0, 0),    # R 8
    (1, 1, 140, 8, 128, 140, True, 0, 0),
    (1, 1, 100, 5, 128, 300, True, 64, 200),  # R 5, window past an offset
])
def test_flash_prefill_tc_emulation_rounds_once(B, G, S, R, hd, T, causal,
                                                window, qoff):
    """The tensor-core kernel's arithmetic (bf16 operands, f32 products, the
    scale on S, P split into bf16 hi + lo) returns the f32 result rounded
    once: within half a bf16 ulp + 2e-5 of ``flash_prefill_ref``'s f32
    result on the same bf16 inputs, the bound chip_smoke.py holds the
    kernel to."""
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, G, S, R, hd), (B, G, T, hd), (B, G, T, hd)))
    out = ref.flash_prefill_tc_emulation(q, k, v, causal=causal,
                                         window=window, q_offset=qoff)
    assert out.dtype == torch.bfloat16
    want32 = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   q_offset=qoff)
    lim = 2.0 ** -8 * want32.abs() + 2e-5
    assert bool(((out.float() - want32).abs() <= lim).all())


def test_flash_prefill_tc_emulation_matches_the_pallas_kernel_at_r5():
    """The wgmma kernel's arithmetic (128-key tiles, 64-row groups that end
    inside a position at R 5) against the JAX Pallas kernel in interpret
    mode on the same bf16 inputs, at the bf16 tolerance, and rounded once."""
    B, G, S, R, hd, T, qoff = 1, 1, 64, 5, 128, 256, 192
    rng = np.random.RandomState(17)
    q = rng.randn(B, G, S, R, hd).astype(np.float32)
    k = rng.randn(B, G, T, hd).astype(np.float32)
    v = rng.randn(B, G, T, hd).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, "bfloat16") for x in (q, k, v))
    out = ref.flash_prefill_tc_emulation(qt, kt, vt, causal=True,
                                         q_offset=qoff)
    _close(out, jax_flash_prefill(qj, kj, vj, causal=True, q_offset=qoff,
                                  q_block=32, kv_block=128, interpret=True),
           3e-2)
    want32 = ref.flash_prefill_ref(qt.float(), kt.float(), vt.float(),
                                   causal=True, q_offset=qoff)
    lim = 2.0 ** -8 * want32.abs() + 2e-5
    assert bool(((out.float() - want32).abs() <= lim).all())


@pytest.mark.parametrize("dtype,hd,rows", [
    ("bfloat16", 128, 128), ("bfloat16", 64, 128), ("bfloat16", 32, 64),
    ("bfloat16", 16, 64), ("float32", 128, 64), ("float32", 64, 64),
])
def test_flash_prefill_grid_follows_the_kernel_choice(dtype, hd, rows):
    """The grid the launcher uses: 128 packed rows per block for the wgmma
    kernel (bf16 at hd 64 and 128), 64 for the others; at S = 32,768 and
    R = 2 its second dim stays under CUDA's 65535."""
    from repro_torch.kernels import flash_prefill

    td = DTYPES[dtype][1]
    assert flash_prefill.block_rows(td, hd) == rows
    q = torch.empty((2, 8, 77, 5, hd), dtype=td)
    assert flash_prefill.grid(q) == (16, -(-(77 * 5) // rows))
    assert flash_prefill.grid(torch.empty((1, 8, 32768, 2, hd), dtype=td))[1] \
        <= 65535


def test_paged_attention_arrival_counters_grow_zeroed():
    """The wrapper's per-device arrival counters: at least the asked count,
    all zero; the same buffer while it is large enough, a new zeroed one
    when a call needs more."""
    from repro_torch.kernels import paged_attention

    dev = torch.device("cpu")
    paged_attention._counters.pop(dev.index, None)
    a = paged_attention.arrival_counters(dev, 16)
    assert a.dtype == torch.int32 and a.numel() == 16 and not a.any()
    assert paged_attention.arrival_counters(dev, 8) is a
    b = paged_attention.arrival_counters(dev, 64)
    assert b is not a and b.numel() == 64 and not b.any()
    assert paged_attention.arrival_counters(dev, 64) is b
    paged_attention._counters.pop(dev.index, None)


# --------------------------------------------------------------------------
# the plain compute of whole cells: the dot FLOPs that launch/cells.py's
# trace counts against the reference's HLO dots (the dry run's and the
# roofline row's cases are at the end of this file, the analytic terms' and
# the collectives' in tests/test_torch_engine.py)
# --------------------------------------------------------------------------
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.cells import build_cell, trace_cell  # noqa: E402

FLOP_ARCHS = ["qwen3-1.7b", "gemma3-12b", "granite-moe-3b-a800m"]
SMALL = (64, 8)         # (seq_len, batch) of the shrunk cells


def _small(shape_name):
    from repro_torch.configs import get_shape
    base = get_shape(shape_name)
    return ShapeConfig(base.name, base.kind, *SMALL)


def _port_flops(arch, shape_name, layers=None):
    cfg = get_smoke_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    cell = build_cell(arch, shape_name, None, cfg_override=cfg,
                      shape=_small(shape_name))
    return trace_cell(cell, "cpu").dot_flops


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_cell_step_on_the_cpu_equals_the_cells_function(shape_name):
    """``CellStep`` (the captured cell; eager on the CPU) at smoke size
    against the cell's own function on the same materialised arguments: a
    prefill's logits and cache, a decode's logits and cache, a train step's
    loss, grad norm, parameters and optimizer state (written in place,
    against the eager step's new ones), bit for bit."""
    from repro_torch.launch.cells import CellStep, materialize
    from repro_torch.models.param_utils import tree_flatten

    cfg = get_smoke_config("qwen3-1.7b")

    def made():
        cell = build_cell("qwen3-1.7b", shape_name, None, cfg_override=cfg,
                          shape=_small(shape_name))
        return cell, materialize(cell, "cpu", 0)

    cell, args = made()
    want = cell.fn(*args)
    cell, cargs = made()
    cs = CellStep(cell, cargs)
    assert cs.pool is None
    got = cs.step()
    if cell.kind == "train":
        assert all(torch.equal(got[k], want[2][k]) for k in ("loss", "grad_norm"))
        got_trees = {"params": cargs[0], "opt": cargs[1]}
        want_trees = {"params": want[0], "opt": want[1]}
    else:
        assert torch.equal(got[0], want[0])
        got_trees, want_trees = got[1], want[1]
    (pa, la), (pb, lb) = tree_flatten(got_trees), tree_flatten(want_trees)
    assert pa == pb and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_dot_flops_equal_the_references_scan_corrected(arch, shape_name):
    """One device, smoke configs, shapes shrunk to 64 tokens x 8 rows: the
    port's traced dot FLOPs (FlopCounterMode's mm/bmm/addmm/baddbmm, remat's
    recomputation and the backward included) equal the reference's
    ``corrected_stats(...)["stats"]["dot_flops"]`` (its HLO's dots, the scan
    body composed) to 1e-6, with no product on either side that the other
    lacks."""
    import repro.configs as RC
    import repro.launch.cells as RCells
    import repro.launch.roofline as RR
    from repro.configs.base import ShapeConfig as JaxShape

    smoke = jax_smoke_config(arch)
    base = RC.SHAPES_BY_NAME[shape_name]
    saved = RR.get_config, RCells.get_config
    RC.SHAPES_BY_NAME[shape_name] = JaxShape(base.name, base.kind, *SMALL)
    RR.get_config = RCells.get_config = lambda a: smoke
    try:
        want = RR.corrected_stats(arch, shape_name, None)["stats"]["dot_flops"]
    finally:
        RC.SHAPES_BY_NAME[shape_name] = base
        RR.get_config, RCells.get_config = saved
    assert _port_flops(arch, shape_name) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "rwkv6-7b"])
def test_traced_flops_are_linear_in_layers(arch):
    """The counterpart of tests/test_roofline_accounting.py's scan
    composition: a trace counts every layer, so a prefill's count at L
    layers is count(0) + (L / g) (count(g) - count(0)), g the layer group."""
    cfg = get_smoke_config(arch)
    g = cfg.local_global_pattern + 1 if cfg.attn_kind == "local_global" else 1
    f0, fg, fl = (_port_flops(arch, "prefill_32k", n)
                  for n in (0, g, cfg.num_layers))
    assert fg > f0 > 0
    assert fl == pytest.approx(f0 + cfg.num_layers // g * (fg - f0), rel=1e-9)


# --------------------------------------------------------------------------
# the dry run and the roofline row (launch/{cells,dryrun,roofline}.py)
# --------------------------------------------------------------------------
_DRYRUN_SMALL = r"""
import json
from repro_torch.configs import get_smoke_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import run_cell

MESH = ((2, 2, 2), ("pod", "data", "model"))


def row(arch, shape, whole=False, **cfg):
    base = get_shape(shape)
    return run_cell(arch, shape, False, verbose=False, mesh_shape=MESH,
                    device_type="cpu", whole=whole,
                    cfg_override=get_smoke_config(arch).replace(num_layers=5,
                                                                **cfg),
                    shape=ShapeConfig(base.name, base.kind, 64, 8))


out = {"rows": [row(arch, shape)
                for arch in ("qwen3-1.7b", "qwen3-moe-30b-a3b", "rwkv6-7b")
                for shape in ("train_4k", "decode_32k")]}
out["prefill"] = row("qwen3-1.7b", "prefill_32k")
out["whole"] = {s: row("qwen3-1.7b", s, whole=True)
                for s in ("train_4k", "prefill_32k", "decode_32k")}
# the first row again, after every other trace of the process
out["again"] = row("qwen3-1.7b", "train_4k")
# a vocabulary of 32768: the head's operators at their global shape (8 x
# the rank's) had read as held where DTensor's propagation missed its cache
out["wide"] = [row("qwen3-1.7b", "train_4k", whole, vocab_size=32768)
               for whole in (False, True)]
print("OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def small_dryrun():
    """``dryrun.run_cell`` on a fake world of 8 ranks as (2, 2, 2), smoke
    configs at 5 layers, shapes shrunk to 64 tokens x 8 rows, in one fresh
    process (a process group of its own)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parent.parent / "src")
    proc = subprocess.run([sys.executable, "-c", _DRYRUN_SMALL],
                          capture_output=True, text=True, timeout=400,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("OUT ")][0]
    return json.loads(line[4:])


def _ratio(composed, whole):
    return composed["peak_bytes_per_device"] / whole["peak_bytes_per_device"]


def test_small_mesh_dryrun_on_a_fake_world(small_dryrun):
    """The counterpart of tests/test_dryrun_small.py: every row (dense,
    MoE, rwkv6; train and decode) is ok, with dot FLOPs and collectives, a
    peak and the XLA-only keys null. qwen3's rows are ``trace_composed``'s,
    from 2 and 3 layers, which equals ``trace_cell`` of all 5 in FLOPs and
    collectives, and in peak to 2% (equal for decode)."""
    rows = small_dryrun["rows"]
    assert len(rows) == 6
    for r in rows:
        assert r["mesh"] == "2x2x2" and r["kind"] in ("train", "decode")
        assert r["status"] == "ok", r.get("traceback")
        assert r["dot_flops_per_device"] > 0 and r["peak_bytes_per_device"] > 0
        assert sum(r["collective_counts"].values()) > 0, r
        assert r["num_devices"] == 8
        for k in ("hlo_bytes_per_device", "hlo_flops_per_device",
                  "argument_bytes_per_device", "temp_bytes_per_device",
                  "alias_bytes_per_device"):
            assert r[k] is None, k
    for composed in rows[:2]:
        whole = small_dryrun["whole"][composed["shape"]]
        assert composed["composed_from"] == [2, 3] and whole["composed_from"] is None
        assert composed["trace"] == "composed from 2 and 3 layers"
        assert whole["trace"] == "full"
        for k in ("dot_flops_per_device", "collective_counts",
                  "collective_wire_bytes", "collective_out_bytes"):
            assert composed[k] == whole[k], (k, composed[k], whole[k])
        ratio = _ratio(composed, whole)
        assert ratio == 1.0 if whole["kind"] == "decode" else 0.98 <= ratio <= 1.02, ratio


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_composed_peak_matches_a_whole_trace(small_dryrun, shape_name):
    """qwen3-1.7b at 5 layers on the (2, 2, 2) mesh: the peak composed from
    the step timelines at 2 and 3 layers is within 2% of a trace of all 5
    layers for train and prefill, and equal for decode."""
    whole = small_dryrun["whole"][shape_name]
    composed = (small_dryrun["prefill"] if shape_name == "prefill_32k" else
                small_dryrun["rows"][0 if shape_name == "train_4k" else 1])
    assert composed["shape"] == shape_name and composed["status"] == "ok"
    assert composed["composed_from"] == [2, 3]
    ratio = _ratio(composed, whole)
    assert ratio == 1.0 if shape_name == "decode_32k" else 0.98 <= ratio <= 1.02, ratio


def test_composed_peak_does_not_depend_on_trace_order(small_dryrun):
    """The ZeRO-1 train row of qwen3-1.7b on the (2, 2, 2) mesh composed
    again after every other trace of the process reads the same peak as
    the process's first trace of it: DTensor's sharding propagation, which
    runs its operators at their global shape on a cache miss only, is not
    counted as held."""
    first, again = small_dryrun["rows"][0], small_dryrun["again"]
    assert (first["shape"], again["shape"]) == ("train_4k", "train_4k")
    assert again["traced_peak_bytes"] == first["traced_peak_bytes"]
    assert again["peak_bytes_per_device"] == first["peak_bytes_per_device"]


def test_composed_peak_is_never_below_a_traced_peak(small_dryrun):
    """Every composed row's peak is at least the larger of its two traced
    peaks: a deeper step cannot peak lower. With a vocabulary of 32768 the
    train row had composed below its traces; it is within 2% of the whole
    trace."""
    wide, wide_whole = small_dryrun["wide"]
    composed = (small_dryrun["rows"]
                + [small_dryrun["prefill"], small_dryrun["again"], wide])
    for r in composed:
        assert r["status"] == "ok", r.get("traceback")
        p2, p3 = r["traced_peak_bytes"]
        assert 0 < p2 <= p3 <= r["peak_bytes_per_device"], (r["arch"], r["shape"])
    assert 0.98 <= _ratio(wide, wide_whole) <= 1.02


def _step(groups, block="abc", head="xy", tail="z"):
    """A step's operators as ``match_steps`` takes them: a forward of
    ``head``, ``groups`` blocks and ``tail``, then its backward in
    reverse."""
    fw = head + block * groups + tail
    return [(c, False) for c in fw] + [(c.upper(), True) for c in fw[::-1]]


@pytest.mark.parametrize("deeper,error", [
    (_step(3), None),
    (_step(3, head="xqy"), "not the deeper step"),      # two insertions
    (_step(2)[:8] + [(c, False) for c in "pqr"] + _step(2)[8:],
     "repeat no block"),
    (_step(2) + [("q", False)], "phases differ"),
])
def test_match_steps_pairs_each_operator_with_its_counterpart(deeper, error):
    """Two groups against three: each operator of the shallower step is
    paired with the same operator of the deeper one, the forward's first
    group with the first and its last with the last (the backward's
    likewise); two insertions in one phase, a block that repeats no group
    and a phase too many raise."""
    from repro_torch.launch.cells import match_steps
    a = _step(2)
    if error is not None:
        with pytest.raises(ValueError, match=error):
            match_steps(a, deeper)
        return
    runs = match_steps(a, deeper)
    pairs = [(i + d, j + d) for i, j, n in runs for d in range(n)]
    assert [i for i, _ in pairs] == list(range(len(a)))
    assert all(a[i] == deeper[j] for i, j in pairs)
    # forward: x y | abc abc | z  ->  x y | abc [abc] abc | z
    assert pairs[:5] == [(q, q) for q in range(5)]
    assert pairs[5:9] == [(q, q + 3) for q in range(5, 9)]


def test_roofline_row_has_the_references_keys():
    """``roofline_row`` at one device on a traced smoke cell: the
    reference's keys; the compute term is the dot FLOPs over the H100's
    989 TFLOP/s, no collective, and the bound is the largest term."""
    import inspect
    import re

    import repro.launch.roofline as RR
    from repro_torch.launch import roofline as RL
    shape = _small("prefill_32k")
    cfg = get_smoke_config("qwen3-1.7b")
    row = RL.roofline_row("qwen3-1.7b", "prefill_32k", None, cfg_override=cfg,
                          shape=shape)
    src = inspect.getsource(RR.roofline_row)
    keys = set(re.findall(r'"(\w+)":', src[src.index("return {"):]))
    assert set(row) == keys
    assert row["compute_term_s"] == row["dot_flops_per_device"] / 989e12
    assert row["collective_term_s"] == 0.0 and row["mesh"] == "1"
    assert row["step_time_bound_s"] == max(row["compute_term_s"],
                                           row["memory_term_s"], 0.0)
    assert row["xla_flops_per_device"] is None and not row["scan_corrected"]


# --------------------------------------------------------------------------
# the per-layer init (``param_utils.init_params(by_layer=True)``), the
# default whole draw pinned bit for bit, and the paged engine at Qp 5
# against the JAX package's
# --------------------------------------------------------------------------
import math  # noqa: E402

import jax  # noqa: E402

from repro.core.priority import BatchLimits as JaxBatchLimits  # noqa: E402
from repro.data.datasets import make_dataset as jax_make_dataset  # noqa: E402
from repro.data.trace import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.data.trace import build_trace as jax_build_trace  # noqa: E402
from repro.engine.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving import build_real_engine as jax_build_real_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.priority import BatchLimits  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.distributed.sharding import ParallelConfig  # noqa: E402
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.models.param_utils import ParamTemplate, tree_flatten  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import build_real_engine  # noqa: E402

# Narrow templates of each family with pad Q slots (6 q / 2 kv heads at
# tp 4: 4 slots of 2 rows, 2 of them pad) and pad experts (6 of 8 at tp 4)
INIT_TP = ParallelConfig(tp_axis="model", tp=4)
INIT_ARCHS = {"dense": ("qwen2.5-32b", {}), "vlm": ("internvl2-26b", {}),
              "moe": ("qwen3-moe-30b-a3b", {"num_experts": 6}),
              "whisper": ("whisper-base", {})}
# per-group std of a drawn leaf within this share of 1 / sqrt(fan_in), on
# groups of at least INIT_MIN_VALUES drawn values (the sample std of n
# normal values lies within ~1/sqrt(2n) = 1.1% of the true one)
INIT_STD_TOL = 0.05
INIT_MIN_VALUES = 4096


def _init_model(family):
    arch, kw = INIT_ARCHS[family]
    cfg = get_smoke_config(arch).replace(num_heads=6, num_kv_heads=2, **kw)
    return build_model(cfg, INIT_TP)


def _walk(tree, prefix=""):
    """(path, template) in the order ``init_params`` draws them."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, ParamTemplate):
            yield path, v
        else:
            yield from _walk(v, path)


def _masks(model, path, tm):
    """The leaf's float32 mask of drawn values (0 on pad Q slots and pad
    experts), broadcast to its shape, and the fan_in of its normal draw."""
    name = path.split("/")[-1].removeprefix("sa_").removeprefix("xa_")
    lay, cfg = model.layout, model.cfg
    qmask = torch.as_tensor(lay.q_array() >= 0, dtype=torch.float32)
    ones = torch.ones(tm.shape)
    if tm.custom is None:
        return ones, tm.fan_in or (tm.shape[-2] if len(tm.shape) >= 2
                                   else tm.shape[-1])
    if name == "wq":
        return ones * qmask[:, :, None], cfg.d_model
    if name == "wo":
        return ones * qmask[:, :, None, None], lay.num_heads * cfg.head_dim
    if name in ("wk", "wv"):
        return ones, cfg.d_model
    experts = (torch.arange(tm.shape[-3]) < cfg.num_experts).float()
    return ones * experts[:, None, None], tm.shape[-2]     # w_gate/up/down


def _old_whole_draw(model, gen):
    """An inline copy of the whole-leaf draw as it stood before by_layer
    (every leaf drawn whole in float32, scaled into a second copy, cast)."""
    lay, cfg = model.layout, model.cfg
    dup = torch.as_tensor(lay.dup_array(), dtype=torch.long)
    out = {}
    for path, tm in _walk(model.templates()):
        name = path.split("/")[-1].removeprefix("sa_").removeprefix("xa_")
        mask, fan_in = _masks(model, path, tm)
        if tm.custom is None:
            if tm.init in ("zeros", "ones"):
                w = getattr(torch, tm.init)(tm.shape, dtype=model.dtype)
            else:
                w = torch.randn(tm.shape, generator=gen, dtype=torch.float32)
                w = (w * (1.0 / math.sqrt(max(1, fan_in)))).to(model.dtype)
        elif name in ("wk", "wv"):
            shape = tm.shape[:-2] + (lay.num_kv_heads, tm.shape[-1])
            w = torch.randn(shape, generator=gen, dtype=torch.float32)
            w = (w / math.sqrt(fan_in)).index_select(len(shape) - 2, dup)
            w = w.to(model.dtype)
        elif name in ("wq", "wo"):
            w = torch.randn(tm.shape, generator=gen, dtype=torch.float32)
            w = ((w / math.sqrt(fan_in)) * mask).to(model.dtype)
        else:   # experts
            w = torch.randn(tm.shape, generator=gen, dtype=torch.float32)
            w = w.div_(math.sqrt(fan_in)).mul_(mask).to(model.dtype)
        out[path] = w
    return out


@pytest.mark.parametrize("family", list(INIT_ARCHS))
def test_default_init_is_the_old_whole_draw_bit_for_bit(family):
    model = _init_model(family)
    paths, leaves = tree_flatten(
        model.init_params(torch.Generator().manual_seed(3)))
    old = _old_whole_draw(model, torch.Generator().manual_seed(3))
    assert sorted(paths) == sorted(old)
    for path, leaf in zip(paths, leaves):
        assert leaf.dtype == old[path].dtype and torch.equal(leaf, old[path]), path


@pytest.mark.parametrize("family", list(INIT_ARCHS))
def test_by_layer_init_draws_the_same_distributions(family):
    """by_layer: the default draw's tree, shapes and dtypes; exact zeros,
    ones and zero pad Q slots and pad experts; each group of a drawn
    stacked leaf with std within INIT_STD_TOL of 1/sqrt(fan_in), no two
    groups alike; the same numbers from the same seed. (The CPU generator
    happens to give the whole draw's numbers when a group's size is a
    multiple of 16; CUDA's does not, so that is not held.)"""
    model = _init_model(family)
    whole = model.init_params(torch.Generator().manual_seed(0))
    one = model.init_params(torch.Generator().manual_seed(0), by_layer=True)
    again = model.init_params(torch.Generator().manual_seed(0), by_layer=True)
    paths, leaves = tree_flatten(one)
    tms = dict(_walk(model.templates()))
    assert paths == tree_flatten(whole)[0] == tree_flatten(again)[0]
    assert sorted(paths) == sorted(tms)
    n_checked = 0
    for path, w, w0, w2 in zip(paths, leaves, tree_flatten(whole)[1],
                               tree_flatten(again)[1]):
        tm = tms[path]
        assert w.shape == w0.shape == tm.shape and w.dtype == w0.dtype, path
        assert torch.equal(w, w2), path
        if tm.custom is None and tm.init in ("zeros", "ones"):
            assert torch.equal(w, torch.full(tm.shape, float(tm.init == "ones"),
                                             dtype=w.dtype)), path
            continue
        mask, fan_in = _masks(model, path, tm)
        assert torch.count_nonzero(w.float() * (1 - mask)) == 0, path
        if "/" not in path:          # top-level leaves: drawn whole
            continue
        if tm.shape[0] > 1:
            assert not torch.equal(w[0], w[1]), path
        for g in range(tm.shape[0]):
            vals = w[g].float()[mask[g] > 0]
            if vals.numel() < INIT_MIN_VALUES:
                continue
            n_checked += 1
            std = float(vals.std()) * math.sqrt(fan_in)
            assert abs(std - 1) <= INIT_STD_TOL, (path, g, std)
    assert n_checked >= 8


# the slice as a whole: qwen2.5-32b narrowed to 10 q / 2 kv heads of 16
# (5 q rows per kv slot, as at full width) at 2 layers, with random QKV
# biases, in float32, on the paged engine
QP5_OVERRIDES = dict(num_heads=10, num_kv_heads=2, head_dim=16,
                     dtype="float32")
QP5_TRACE = dict(num_relqueries=3, rate=100.0, seed=4, max_requests=4,
                 output_token_cap=8)


def test_port_paged_engine_at_qp5_matches_jax_engine():
    arch = "qwen2.5-32b"
    jm = jax_build_model(jax_smoke_config(arch).replace(**QP5_OVERRIDES))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(5)
    blocks = dict(jp["blocks"])
    for name in ("bq", "bk", "bv"):
        blocks[name] = 0.3 * rng.randn(*blocks[name].shape).astype(np.float32)
    jp = dict(jp, blocks=blocks)
    tm = build_model(get_smoke_config(arch).replace(**QP5_OVERRIDES))
    assert tm.layout.q_per_slot == 5 and tm.cfg.qkv_bias
    tp = params_from_numpy(jp)
    jtrace = jax_build_trace(
        jax_make_dataset("beer", num_rows=64, seed=1),
        JaxTraceConfig(**QP5_TRACE),
        tokenizer=JaxHashTokenizer(vocab_size=tm.cfg.vocab_size - 2))
    ttrace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                         TraceConfig(**QP5_TRACE),
                         tokenizer=HashTokenizer(vocab_size=tm.cfg.vocab_size - 2))
    jengine = jax_build_real_engine(arch, "relserve", "paged", model=jm,
                                    params=jax.tree.map(jnp.asarray, jp),
                                    max_len=512,
                                    limits=JaxBatchLimits(cap=100_000))
    jengine.run_trace(jtrace)
    engine = build_real_engine(arch, "relserve", "paged", model=tm, params=tp,
                               max_len=512, device="cpu",
                               limits=BatchLimits(cap=100_000))
    report = engine.run_trace(ttrace)
    assert len(report.latencies) == len(ttrace)
    port = [tuple(r.output_tokens) for rq in ttrace for r in rq.requests]
    want = [tuple(r.output_tokens) for rq in jtrace for r in rq.requests]
    assert port == want and all(len(s) >= 1 for s in port)


# --------------------------------------------------------------------------
# the executors' shape buckets (one CUDA graph each on the card; eager steps
# here) against the executables the reference's executors compile
# --------------------------------------------------------------------------
import functools  # noqa: E402

from repro.core.batch import Batch as JaxBatch  # noqa: E402

# every relQuery at t = 0 and prefills of at most 512 (128) tokens a batch:
# the batches follow from the trace alone, and under the pipelined loop the
# speculative plans bring new prefill buckets, which prestage captures
BUCKET_TRACE = dict(num_relqueries=3, rate=1e9, seed=2, max_requests=3,
                    output_token_cap=3)
BUCKET_CASES = [("qwen3-1.7b", "paged", "serial", 512),
                ("qwen3-1.7b", "paged", "pipelined", 512),
                ("rwkv6-7b", "dense", "serial", 128),
                ("rwkv6-7b", "dense", "pipelined", 128)]
# zero-initialised RWKV6 params that get random values, so every path works
BUCKET_RWKV_NOISE = ("ln1_b", "ln2_b", "mu_base", "mu", "lora_b", "w0", "wd2",
                     "bonus", "mu_ck", "mu_cr")


@functools.lru_cache(maxsize=None)
def _bucket_models(arch):
    """The 2-layer smoke config in float32, one set of weights for both."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    if arch == "rwkv6-7b":
        rng = np.random.RandomState(4)
        blocks = dict(jp["blocks"])
        for name in BUCKET_RWKV_NOISE:
            blocks[name] = 0.3 * rng.randn(*blocks[name].shape).astype(np.float32)
        jp = dict(jp, blocks=blocks)
    tm = build_model(get_smoke_config(arch).replace(dtype="float32"))
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_numpy(jp)


def _bucket_keys(ex, backend):
    if backend == "dense":
        return sorted(ex._prefill_fn), ex._decode_fn is not None
    return tuple(sorted(getattr(ex, f"_{n}_fn"))
                 for n in ("prefill", "scatter", "decode"))


def _record_prestage(ex):
    """The prefill keys each ``prestage`` call adds, in call order."""
    added, inner = [], ex.prestage

    def prestage(batch):
        before = set(ex._prefill_fn)
        inner(batch)
        added.append(sorted(set(ex._prefill_fn) - before))

    ex.prestage = prestage
    return added


def _jax_bucket_trace(vocab):
    return jax_build_trace(jax_make_dataset("beer", num_rows=64, seed=1),
                           JaxTraceConfig(**BUCKET_TRACE),
                           tokenizer=JaxHashTokenizer(vocab_size=vocab))


def _one_at_a_time(ex, trace):
    """Greedy streams of the reference's dense executor ``ex`` (its slots
    free) serving each request alone (no batch decodes beside a prefill):
    the streams the port's off-batch rule keeps for a recurrent model
    (test_torch_engine.py)."""
    streams = []
    for rq in trace:
        for r in rq.requests:
            batch = JaxBatch("prefill", prefill_requests=[r])
            while True:
                _, res = ex.execute(batch, 0.0)
                tok, done = res.outputs[r.req_id]
                r.output_tokens.append(tok)
                if done:
                    break
                batch = JaxBatch("decode", decode_requests=[r])
            ex.release_request(r.req_id)
            streams.append(tuple(r.output_tokens))
    return streams


@pytest.mark.parametrize("arch,backend,loop,mnbt", BUCKET_CASES)
def test_executor_buckets_match_the_references(arch, backend, loop, mnbt):
    """The keys of the port's steps (dense ``_prefill_fn``, ``_decode_fn``;
    paged ``_prefill_fn``, ``_scatter_fn``, ``_decode_fn``) equal the
    reference executor's compiled ones after one trace, the keys each
    ``prestage`` adds equal the reference's, and the f32 streams equal the
    reference's (rwkv6: served one request at a time)."""
    jm, jp, tm, tp = _bucket_models(arch)
    vocab = tm.cfg.vocab_size - 2
    jtrace = _jax_bucket_trace(vocab)
    ttrace = build_trace(make_dataset("beer", num_rows=64, seed=1),
                         TraceConfig(**BUCKET_TRACE),
                         tokenizer=HashTokenizer(vocab_size=vocab))
    jengine = jax_build_real_engine(
        arch, "relserve", backend, model=jm, params=jp, max_len=256,
        engine_loop=loop,
        limits=JaxBatchLimits(max_num_batched_tokens=mnbt, cap=100_000))
    jadded = _record_prestage(jengine.executor)
    jengine.run_trace(jtrace)
    engine = build_real_engine(
        arch, "relserve", backend, model=tm, params=tp, max_len=256,
        engine_loop=loop, device="cpu",
        limits=BatchLimits(max_num_batched_tokens=mnbt, cap=100_000))
    ex = engine.executor
    added = _record_prestage(ex)
    engine.run_trace(ttrace)
    assert _bucket_keys(ex, backend) == _bucket_keys(jengine.executor, backend)
    assert added == jadded
    assert any(added) == (loop == "pipelined")
    assert ex.num_graphs == 0 and ex.capture_s > 0
    assert ex.prefill_calls == sum(s.calls for s in ex._prefill_fn.values()) > 0
    port = [tuple(r.output_tokens) for rq in ttrace for r in rq.requests]
    if arch == "rwkv6-7b":
        want = _one_at_a_time(jengine.executor, _jax_bucket_trace(vocab))
    else:
        want = [tuple(r.output_tokens) for rq in jtrace for r in rq.requests]
    assert port == want and all(port)
