"""Each ported primitive of ``repro_torch.models.layers`` against its JAX
twin in ``repro.models.layers``, on the same numpy inputs; the training
primitives (GELU MLP, chunked cross-entropy and its gradient, AdamW) against
``repro.models.layers`` and ``repro.training.optimizer``; the kernel
wrappers refuse inputs that require grad.

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


# ----------------------------------------------------------------------------
# training primitives: the GELU MLP, the chunked cross-entropy, AdamW
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_gelu_mlp(dtype, tol):
    x = _both(_rand(2, 5, 16), dtype)
    w_in = _both(0.3 * _rand(16, 24, seed=1), dtype)
    b_in = _both(0.1 * _rand(24, seed=2), dtype)
    w_out = _both(0.3 * _rand(24, 16, seed=3), dtype)
    b_out = _both(0.1 * _rand(16, seed=4), dtype)
    args = list(zip(x, w_in, b_in, w_out, b_out))
    _close(TL.gelu_mlp(*args[1]), JL.gelu_mlp(*args[0]), tol)


@pytest.mark.parametrize("S,num_chunks,vocab_valid,z_loss", [
    (16, 8, 0, 0.0),       # chunks of 2
    (12, 8, 29, 0.0),      # 12 // 8 = 1 divides 12; pad columns masked
    (20, 3, 0, 1e-2),      # 20 // 3 = 6 halves to 3, then to 1; z-loss
    (7, 4, 30, 1e-3),      # S odd: chunks of 1
])
def test_chunked_softmax_xent(S, num_chunks, vocab_valid, z_loss):
    """Sum and count against the reference, labels with -1 pads, float32:
    the sum to 1e-5, the count exact; and the gradient of the mean loss with
    respect to x and the vocabulary matrix to 1e-5 of its largest value."""
    import jax

    B, D, Vp = 3, 8, 32
    x = _rand(B, S, D)
    w = _rand(D, Vp, seed=1)
    labels = np.random.RandomState(2).randint(0, vocab_valid or Vp,
                                              size=(B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, -1] = -1
    kw = dict(num_chunks=num_chunks, z_loss=z_loss, vocab_valid=vocab_valid)
    tot_j, cnt_j = JL.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(labels), **kw)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tot_t, cnt_t = TL.chunked_softmax_xent(xt, wt, torch.from_numpy(labels),
                                           **kw)
    assert tot_t.dtype == cnt_t.dtype == torch.float32
    assert float(cnt_t) == float(cnt_j) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(tot_t.detach()), float(tot_j), rtol=1e-5)
    gx, gw = torch.autograd.grad(tot_t / cnt_t, (xt, wt))
    jgx, jgw = jax.grad(lambda a, b: (lambda t, c: t / c)(
        *JL.chunked_softmax_xent(a, b, jnp.asarray(labels), **kw)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for got, want in ((gx, jgx), (gw, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0)


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b", "whisper-base"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(arch, dtype):
    """Two AdamW steps (the second from the first's state) on the smoke
    config's parameter tree with random gradients, clipped (global norm over
    1): new params, m, v and master within 1e-5 (float32 state), step and
    grad norm; every param comes back in the first leaf's dtype, the
    reference's cast."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.training.optimizer import adamw_update as jax_adamw_update
    from repro.training.optimizer import init_opt_state as jax_init_opt_state
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.param_utils import tree_flatten
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)

    jm = jax_build_model(jax_smoke_config(arch).replace(dtype=dtype))
    jp = jm.init_params(jax.random.PRNGKey(1))
    rng = np.random.RandomState(3)
    grads_np = [jax.tree.map(lambda a: (2.0 * rng.randn(*a.shape)).astype(
        np.float32), jp) for _ in range(2)]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jo, to = jax_init_opt_state(jp), init_opt_state(tp)
    cfg, jcfg = AdamWConfig(lr=1e-2), JaxAdamWConfig(lr=1e-2)
    for g in grads_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)), g)
        tg = params_from_numpy(jax.tree.map(np.asarray, jg))
        jp, jo, jmet = jax_adamw_update(jp, jg, jo, jcfg)
        tp, to, tmet = adamw_update(tp, tg, to, cfg)
        assert float(jmet["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 2
    assert to["err"] is None
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, tree, jtree in (("params", tp, jp), ("m", to["m"], jo["m"]),
                              ("v", to["v"], jo["v"]),
                              ("master", to["master"], jo["master"])):
        paths, leaves = tree_flatten(tree)
        jleaves = jax.tree_util.tree_leaves(jtree)
        assert len(leaves) == len(jleaves)
        for p, got, want in zip(paths, leaves, jleaves):
            want = np.asarray(want.astype(jnp.float32))
            assert got.dtype == (want_dtype if name == "params"
                                 else torch.float32), (name, p)
            tol = 1e-5 if got.dtype == torch.float32 else 2 ** -8
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=tol * max(np.abs(want).max(), 1e-30),
                                       rtol=tol, err_msg=f"{name} {p}")


def test_tree_helpers_flatten_in_jax_order():
    """Sorted keys, '/'-joined paths, None no leaf; unflatten inverts."""
    import jax

    from repro_torch.models.param_utils import (tree_flatten, tree_map,
                                                tree_unflatten)

    tree = {"v": {"b": 1, "a": 2}, "step": 3, "err": None, "m": {"z": 4}}
    paths, leaves = tree_flatten(tree)
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert leaves == [leaf for _, leaf in jflat] == [4, 3, 2, 1]
    assert paths == ["/".join(str(k.key) for k in p) for p, _ in jflat]
    assert tree_unflatten(tree, leaves) == tree
    assert tree_map(lambda a, b: a + b, tree, tree)["v"] == {"b": 2, "a": 4}


@pytest.mark.parametrize("name", ["paged_attention", "flash_prefill",
                                  "rwkv6_chunk"])
def test_kernel_wrappers_raise_on_inputs_that_require_grad(name):
    """The kernels are forward-only: a wrapper never returns a result that
    autograd cannot see through, on either device."""
    from repro_torch.kernels import ops

    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    if name == "paged_attention":
        args = [t(1, 2, 2, 16), t(3, 4, 2, 16), t(3, 4, 2, 16),
                torch.zeros((1, 2), dtype=torch.int32),
                torch.ones((1,), dtype=torch.int32)]
        grad_at = 1
    elif name == "flash_prefill":
        args = [t(1, 2, 16, 2, 16), t(1, 2, 16, 16), t(1, 2, 16, 16)]
        grad_at = 0
    else:
        args = [t(1, 16, 2, 8), t(1, 16, 2, 8), t(1, 16, 2, 8),
                -torch.rand(1, 16, 2, 8), t(2, 8), t(1, 2, 8, 8)]
        grad_at = 3
    fn = getattr(ops, name)
    fn(*args)           # forward-only inputs run (the plain version here)
    args[grad_at].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args)
