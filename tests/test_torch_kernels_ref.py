"""The port's plain attention kernels (``repro_torch.kernels.ref``) against
the JAX package's Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) and the JAX oracles, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: 1e-5 in float32, 2e-2 for
paged attention and 3e-2 for flash prefill in bfloat16. Contexts are >= 1
token except in the test that pins the ``ctx == 0`` convention, where the
port follows the Pallas kernel (zeros), not the JAX oracle (mean of V).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged_attention  # noqa: E402
from repro.kernels.ref import flash_prefill_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
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
    assert ops.launch_counts() == {"paged_attention": 0, "flash_prefill": 0}


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
