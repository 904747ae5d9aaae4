"""Each ported primitive of ``repro_torch.models.layers`` against its JAX
twin in ``repro.models.layers``, on the same numpy inputs.

float32 is held to 1e-5 (1e-6 for the elementwise functions), where the only
difference left is the order of float32 sums; bfloat16 outputs to 2e-2, one
or two bf16 roundings apart. The cache writes are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(x, dtype="float32"):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x)).to(td)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_rmsnorm(dtype, tol):
    xj, xt = _both(_rand(3, 5, 64), dtype)
    sj, st = _both(0.1 * _rand(64, seed=1), dtype)
    out = TL.rmsnorm(xt, st, 1e-6)
    assert out.dtype == xt.dtype
    _close(out, JL.rmsnorm(xj, sj, 1e-6), tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_act_fn(name):
    xj, xt = _both(_rand(4, 32))
    _close(TL.act_fn(name)(xt), JL.act_fn(name)(xj), 1e-6)


def test_rope_freqs():
    _close(TL.rope_freqs(128, 1e6), JL.rope_freqs(128, 1e6), 1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_apply_rope(dtype, tol):
    xj, xt = _both(_rand(2, 7, 3, 2, 16), dtype)
    pos = np.random.RandomState(3).randint(0, 4000, size=(2, 7)).astype(np.int32)
    out = TL.apply_rope(xt, torch.from_numpy(pos)[:, :, None, None], 1e6)
    _close(out, JL.apply_rope(xj, jnp.asarray(pos)[:, :, None, None], 1e6), tol)
    assert TL.apply_rope(xt, torch.from_numpy(pos), 0.0) is xt


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S,T,causal,window,qoff,blocks,lens", [
    (64, 64, True, 0, 0, None, [64, 37]),
    (64, 64, True, 16, 0, (16, 16), None),       # window, skipped blocks
    (32, 96, True, 0, 64, (16, 32), None),       # prefix offset
    (32, 32, False, 0, 0, (16, 16), [32, 5]),    # non-causal, ragged keys
])
def test_block_attention(S, T, causal, window, qoff, blocks, lens, dtype, tol):
    B, G, Qp, hd = 2, 2, 2, 16
    qj, qt = _both(_rand(B, S, G, Qp, hd, seed=1), dtype)
    kj, kt = _both(_rand(B, T, G, hd, seed=2), dtype)
    vj, vt = _both(_rand(B, T, G, hd, seed=3), dtype)
    qb, kb = blocks or (None, None)
    sl = None if lens is None else np.asarray(lens, np.int32)
    out = TL.block_attention(
        qt, kt, vt, causal=causal, window=window, q_offset=qoff,
        seq_lens=None if sl is None else torch.from_numpy(sl),
        q_block=qb, kv_block=kb)
    want = JL.block_attention(
        qj, kj, vj, causal=causal, window=window, q_offset=qoff,
        seq_lens=None if sl is None else jnp.asarray(sl),
        q_block=qb, kv_block=kb)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention(window, dtype, tol):
    B, T, G, Qp, hd = 3, 8 if window else 24, 2, 2, 16
    qj, qt = _both(_rand(B, G, Qp, hd, seed=4), dtype)
    kj, kt = _both(_rand(B, T, G, hd, seed=5), dtype)
    vj, vt = _both(_rand(B, T, G, hd, seed=6), dtype)
    pos = np.array([0, 5, 19 if window else 23], np.int32)
    out = TL.decode_attention(qt, kt, vt, torch.from_numpy(pos), window=window)
    _close(out, JL.decode_attention(qj, kj, vj, jnp.asarray(pos),
                                    window=window), tol)


@pytest.mark.parametrize("window", [0, 4])
def test_cache_writes(window):
    B, T, G, hd = 3, 8, 2, 4
    cache = _rand(B, T, G, hd, seed=7)
    new = _rand(B, G, hd, seed=8)
    pos = np.array([1, 6, 11 if window else 7], np.int32)
    cache_t = torch.from_numpy(cache.copy())
    out = TL.cache_write(cache_t, torch.from_numpy(new), torch.from_numpy(pos),
                         window=window)
    assert out is cache_t                      # written in place
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JL.cache_write(jnp.asarray(cache),
                                               jnp.asarray(new),
                                               jnp.asarray(pos), window)))
    full = _rand(2, 1, B, T, G, hd, seed=9)
    full_t = torch.from_numpy(full.copy())
    out = TL.cache_write_full(full_t, 1, 0, torch.from_numpy(new),
                              torch.from_numpy(pos), window)
    assert out is full_t
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JL.cache_write_full(
            jnp.asarray(full), 1, 0, jnp.asarray(new), jnp.asarray(pos),
            window)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_swiglu_mlp(dtype, tol):
    xj, xt = _both(_rand(4, 32, seed=10), dtype)
    ws = [_both(_rand(*s, seed=11 + i) / np.sqrt(s[0]), dtype)
          for i, s in enumerate([(32, 64), (32, 64), (64, 32)])]
    out = TL.swiglu_mlp(xt, *(w[1] for w in ws))
    _close(out, JL.swiglu_mlp(xj, *(w[0] for w in ws)), tol)


def test_causal_positions():
    out = TL.causal_positions(5, 3)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JL.causal_positions(5, 3)))


def test_layernorm_and_groupnorm_heads():
    x = 3.0 * _rand(3, 5, 64, seed=5) + 0.5
    scale, bias = _rand(64, seed=6), _rand(64, seed=7)
    jx, tx = _both(x)
    (js, ts), (jb, tb) = _both(scale), _both(bias)
    _close(TL.layernorm(tx, ts, tb, 1e-6), JL.layernorm(jx, js, jb, 1e-6), 1e-6)
    jh, th = _both(x.reshape(3, 5, 4, 16))
    _close(TL.groupnorm_heads(th, torch.ones(())),
           JL.groupnorm_heads(jh, jnp.ones(())), 1e-6)
    # both cast back to the input dtype
    _, xb = _both(x, "bfloat16")
    assert TL.layernorm(xb, ts, tb).dtype == torch.bfloat16
    assert TL.groupnorm_heads(xb.reshape(3, 5, 4, 16), torch.ones(())).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("S,W,lens", [
    (5, 8, None),              # shorter than the ring: zero-padded
    (19, 8, None),             # wraps twice
    (16, 8, [16, 11, 3, 8]),   # ragged rows: wrapped, short, exactly W
    (32, 8, [32, 9, 1, 17]),
])
def test_ring_from_sequence(S, W, lens):
    """A prefill's window cache in ring-slot order, as the reference builds
    it, then decode writes that wrap the ring and a windowed decode over it:
    all exact but the attention (float32, 1e-5)."""
    B = 4
    k = _rand(B, S, 2, 4, seed=10)
    sl = None if lens is None else np.asarray(lens, np.int32)
    ring_t = TL.ring_from_sequence(torch.from_numpy(k), W,
                                   None if sl is None else torch.from_numpy(sl))
    ring_j = JL.ring_from_sequence(jnp.asarray(k), W,
                                   None if sl is None else jnp.asarray(sl))
    np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
    pos = np.full((B,), S, np.int32) if sl is None else sl.copy()
    q = _rand(B, 2, 3, 4, seed=11)
    for step in range(W + 3):
        new = _rand(B, 2, 4, seed=12 + step)
        TL.cache_write(ring_t, torch.from_numpy(new), torch.from_numpy(pos),
                       window=W)
        ring_j = JL.cache_write(ring_j, jnp.asarray(new), jnp.asarray(pos), W)
        np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
        out = TL.decode_attention(torch.from_numpy(q), ring_t, ring_t,
                                  torch.from_numpy(pos), window=W)
        _close(out, JL.decode_attention(jnp.asarray(q), ring_j, ring_j,
                                        jnp.asarray(pos), window=W), 1e-5)
        pos = pos + 1
