"""Each ported primitive of ``repro_torch.models.layers`` against its JAX
twin in ``repro.models.layers``, on the same numpy inputs; the training
primitives (GELU MLP, chunked cross-entropy and its gradient, AdamW) against
``repro.models.layers`` and ``repro.training.optimizer``; the kernel
wrappers refuse inputs that require grad.

The multi-device half: ``ParallelConfig``, the specs of every arch and of
the sequence-parallel model, ZeRO-1 specs and GQA packing against
``repro.distributed.sharding`` and ``repro.training.optimizer``; the packed
layouts at tp 4 on one device against the JAX models; then one gloo world
of 8 ranks (``tests/_torch_mesh_worker.py``, spawned once for the file)
against one JAX process with 8 host devices at the same meshes: sequence-
parallel decode, local expert-parallel dispatch, shard placement, ZeRO-1
AdamW and elastic restore.

float32 is held to 1e-5 (1e-6 for the elementwise functions), where the only
difference left is the order of float32 sums; bfloat16 outputs to 2e-2, one
or two bf16 roundings apart. The cache writes are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.models.seq_parallel import SeqParallelDenseTransformer as JaxSP  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.seq_parallel import SeqParallelDenseTransformer  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402


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


# --------------------------------------------------------------------------
# multi-device: specs, packed layouts at tp > 1, and a gloo world of 8 ranks
# --------------------------------------------------------------------------

# the three layouts the specs are held under: one device, the reference's
# (2, 4) ("data", "model") test mesh, and (2, 2, 2) ("pod", "data", "model")
PCS = {"single": ((), None, 1, 1),
       "data2_model4": (("data",), "model", 4, 2),
       "pod2_data2_model2": (("pod", "data"), "model", 2, 4)}


def _jax_leaves(tree, is_leaf=None):
    """{'a/b': leaf} of a JAX pytree (None is no leaf)."""
    return {"/".join(str(k.key) for k in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _port_leaves(tree):
    from repro_torch.models.param_utils import tree_flatten
    return dict(zip(*tree_flatten(tree)))


def _same_specs(port, ref):
    """Two spec trees, leaf for leaf (path, entries)."""
    from jax.sharding import PartitionSpec
    want = {k: tuple(v) for k, v in _jax_leaves(
        ref, is_leaf=lambda x: isinstance(x, PartitionSpec)).items()}
    got = {k: tuple(v) for k, v in _port_leaves(port).items()}
    assert got == want


class _Mesh:
    """What ``placements`` reads of a DeviceMesh: its dim names and shape."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


@pytest.mark.parametrize("pc_name", list(PCS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, pc_name):
    """Template shapes, param_specs, cache_specs and ZeRO-1 opt_state_specs
    of every arch (and the sequence-parallel model's, for the dense ones)
    equal the JAX package's, leaf for leaf, under each layout."""
    tpc, jpc = TS.ParallelConfig(*PCS[pc_name]), JS.ParallelConfig(*PCS[pc_name])
    jm = jax_build_model(jax_smoke_config(arch), jpc)
    tm = build_model(get_smoke_config(arch), tpc)
    models = [(tm, jm)]
    if type(tm).__name__ == "DenseTransformer":
        models.append((SeqParallelDenseTransformer(get_smoke_config(arch), tpc),
                       JaxSP(jax_smoke_config(arch), jpc)))
    for t, j in models:
        shapes = {k: tuple(v.shape) for k, v in _jax_leaves(j.abstract_params()).items()}
        abstract = t.abstract_params()
        assert {k: tuple(v.shape) for k, v in _port_leaves(abstract).items()} == shapes
        assert all(v.device.type == "meta" for v in _port_leaves(abstract).values())
        _same_specs(t.param_specs(), j.param_specs())
        _same_specs(t.cache_specs(), j.cache_specs())
        _same_specs(TO.opt_state_specs(t.param_specs(), abstract, tpc),
                    JO.opt_state_specs(j.param_specs(), j.abstract_params(), jpc))
        assert {k: tuple(v.shape) for k, v in _port_leaves(
            TO.abstract_opt_state(abstract)).items()} == {
            k: tuple(v.shape) for k, v in _jax_leaves(
                JO.abstract_opt_state(j.abstract_params())).items()}
        if tpc.tp_axis:      # placements on a mesh of the layout's shape
            names = tpc.dp_axes + (tpc.tp_axis,)
            mesh = _Mesh((2,) * len(tpc.dp_axes) + (tpc.tp,), names)
            specs = _port_leaves(t.param_specs())
            for path, pl in _port_leaves(t.param_shardings(mesh)).items():
                assert pl == TS.placements(specs[path], mesh,
                                           _port_leaves(abstract)[path].shape)


def test_zero1_spec_and_parallel_config_on_hand_made_cases():
    P = TS.PartitionSpec
    pc = TS.ParallelConfig(("pod", "data"), "model", 2, 4)
    cases = [((None, "model"), (8, 6)), (("model", None), (6, 8)),
             ((None, None), (3, 8)), ((None,), (2,)),
             ((("pod", "data"), None), (8, 8)), ((), (4, 5))]
    for spec, shape in cases:
        got = TO.zero1_spec(P(*spec), shape, pc)
        want = JO.zero1_spec(jax.sharding.PartitionSpec(*spec), shape,
                             JS.ParallelConfig(("pod", "data"), "model", 2, 4))
        assert tuple(got) == tuple(want) and isinstance(got, P), (spec, shape)
    assert tuple(TO.zero1_spec(P(None, "model"), (8, 6), pc)) == (("pod", "data"), "model")
    assert TO.zero1_spec(P("model"), (8,), TS.ParallelConfig.single_device()) == P("model")
    one = TS.ParallelConfig(("data",), "model", 4, 2)
    assert tuple(one.spec("batch", "ff", None)) == ("data", "model", None)
    assert tuple(pc.spec("batch", "vocab")) == (("pod", "data"), "model")
    assert tuple(TS.ParallelConfig.single_device().spec("batch", "heads")) == (None, None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        pc.spec("rows")


def test_placements_and_uneven_shards():
    from torch.distributed.tensor import Replicate, Shard
    P = TS.PartitionSpec
    m = _Mesh((2, 2, 2), ("pod", "data", "model"))
    assert TS.placements(P(("pod", "data"), None, "model"), m, (8, 3, 4)) == [
        Shard(0), Shard(0), Shard(2)]
    assert TS.placements(P(None), m, (5,)) == [Replicate()] * 3
    pc = TS.ParallelConfig.from_mesh(m)
    assert (pc.dp_axes, pc.tp_axis, pc.tp, pc.dp) == (("pod", "data"), "model", 2, 4)
    for spec, shape in ((P("model"), (5,)), (P(None, ("pod", "data")), (2, 6)),
                        (P(("data", "pod")), (8,)), (P("model", "model"), (4, 4)),
                        (P("expert"), (4,))):
        with pytest.raises(ValueError):
            TS.placements(spec, m, shape)


@pytest.mark.parametrize("head_axis", [0, 1, 2])
@pytest.mark.parametrize("H,KV,tp", [(4, 2, 4), (3, 1, 4), (40, 8, 16), (8, 8, 2)])
def test_gqa_packing_is_the_reference_bit_for_bit(H, KV, tp, head_axis):
    rng = np.random.RandomState(0)
    tl, jl = TS.gqa_layout(H, KV, tp), JS.gqa_layout(H, KV, tp)
    assert (tl.kv_slots, tl.q_per_slot, tl.dup_map, tl.q_map) == (
        jl.kv_slots, jl.q_per_slot, jl.dup_map, jl.q_map)
    shape = [3, 5, 7]
    shape[head_axis] = H
    w = rng.randn(*shape).astype(np.float32)
    packed = TS.pack_q_weight(w, tl, head_axis)
    assert packed.tobytes() == JS.pack_q_weight(w, jl, head_axis).tobytes()
    back = TS.unpack_q_output(packed, tl, head_axis)
    assert back.tobytes() == JS.unpack_q_output(packed, jl, head_axis).tobytes()
    assert back.tobytes() == w.tobytes()
    shape[head_axis] = KV
    kv = rng.randn(*shape).astype(np.float32)
    assert TS.pack_kv_weight(kv, tl, head_axis).tobytes() == \
        JS.pack_kv_weight(kv, jl, head_axis).tobytes()
    assert TS.shardable(tl.kv_slots, tp) and TS.tp_dim(H * 16, TS.ParallelConfig(
        tp=tp)) == JS.tp_dim(H * 16, JS.ParallelConfig(tp=tp))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_packed_layout_at_tp4_on_one_device_equals_the_reference(arch):
    """DenseTransformer / MoETransformer built for tp 4 (packed GQA slots, the
    vocab padded from 250 to 252 with its pad logits masked, granite's 5
    experts padded to 8 zero-weight ones), on weights carried from JAX built
    with ParallelConfig(tp=4): prefill and decode logits at 1e-5 in float32,
    pad columns included."""
    import jax.numpy as jnp

    from repro_torch.bridge import params_from_numpy
    cfg = dict(vocab_size=250, dtype="float32")
    jm = jax_build_model(jax_smoke_config(arch).replace(**cfg), JS.ParallelConfig(tp=4))
    tm = build_model(get_smoke_config(arch).replace(**cfg), TS.ParallelConfig(tp=4))
    jp = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    jp["blocks"] = dict(jp["blocks"], **{
        k: jnp.asarray(0.1 * rng.randn(*jp["blocks"][k].shape), jnp.float32)
        for k in ("ln1", "ln2", "q_norm", "k_norm") if k in jp["blocks"]})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tm.layout.kv_slots == 4 and tp["embed"].shape[0] == 252
    if arch.startswith("granite"):
        assert tm.padded_experts == 8
        assert not tp["blocks"]["w_gate"][:, :, 5:].any()
    toks = rng.randint(0, 250, (3, 12)).astype(np.int32)
    lens = np.array([12, 7, 3], np.int32)
    nxt = rng.randint(0, 250, (3,)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens), max_len=16)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), seq_lens=torch.from_numpy(lens),
                        max_len=16)
    td, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), torch.from_numpy(lens))
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        assert (want[:, 250:] == -1e30).all() and (got[:, 250:] == -1e30).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want[:, :250]).max())


@pytest.mark.parametrize("arch,tp", [("qwen3-1.7b", 4), ("qwen2-0.5b", 4),
                                     ("qwen2-0.5b", 1)])
def test_params_from_packed_inverts_the_reference_packing(arch, tp):
    """Canonical attention weights packed by the reference's pack_q_weight /
    pack_kv_weight at ``tp`` (duplicated KV slots, zero pad Q slots), then
    params_from_packed: the canonical weights back, bit for bit, in the
    sequence-parallel model's template shapes."""
    from repro_torch.models.seq_parallel import params_from_packed
    from repro_torch.models.transformer import DenseTransformer
    cfg = get_smoke_config(arch).replace(dtype="float32")
    pc = TS.ParallelConfig(tp=tp)
    base, sp = DenseTransformer(cfg, pc), SeqParallelDenseTransformer(cfg, pc)
    lay, jl = base.layout, JS.gqa_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    rng = np.random.RandomState(0)
    canon = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in _port_leaves(sp.abstract_params()["blocks"]).items()}
    G, Pg, D = base.n_groups, base.group, cfg.d_model
    H, hd = cfg.num_heads, cfg.head_dim
    packed = dict(canon)
    packed["wq"] = JS.pack_q_weight(canon["wq"], jl, 3).reshape(
        G, Pg, D, lay.kv_slots, lay.q_per_slot, hd)
    packed["wk"] = JS.pack_kv_weight(canon["wk"], jl, 3)
    packed["wv"] = JS.pack_kv_weight(canon["wv"], jl, 3)
    packed["wo"] = JS.pack_q_weight(canon["wo"].reshape(G, Pg, H, hd, D), jl, 2
                                    ).reshape(G, Pg, lay.kv_slots, lay.q_per_slot, hd, D)
    if cfg.qkv_bias:
        packed["bq"] = JS.pack_q_weight(canon["bq"], jl, 2).reshape(
            G, Pg, lay.kv_slots, lay.q_per_slot, hd)
        packed["bk"] = JS.pack_kv_weight(canon["bk"], jl, 2)
        packed["bv"] = JS.pack_kv_weight(canon["bv"], jl, 2)
    for k, v in packed.items():
        assert v.shape == tuple(base.abstract_params()["blocks"][k].shape), k
    back = params_from_packed(
        {"blocks": {k: torch.from_numpy(v) for k, v in packed.items()}}, base)
    for k, v in canon.items():
        assert back["blocks"][k].numpy().tobytes() == v.tobytes(), k


_JAX_MESH_SCRIPT = r"""import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed.sharding import ParallelConfig, pack_kv_weight, pack_q_weight
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.launch.hlo_stats import collective_stats
from repro.models.moe import moe_dispatch_local_ep
from repro.models.registry import build_model
from repro.models.seq_parallel import SeqParallelDenseTransformer, reshard_cache_from_packed
from repro.models.transformer import DenseTransformer
from repro.training.optimizer import opt_state_specs

out = {}
mesh = compat_make_mesh((2, 4), ("data", "model"))
compat_set_mesh(mesh)
pc = ParallelConfig.from_mesh(mesh)


def coords(m):
    return {d.id: "_".join(map(str, i)) for i, d in np.ndenumerate(m.devices)}


def flat(tree, prefix, is_leaf=None):
    for path, x in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        yield prefix + "/" + "/".join(str(k.key) for k in path), x


# -- sequence-parallel decode: qwen3 (2 layers) and gemma3 (5 window : 1)
for arch in ("qwen3-1.7b", "gemma3-12b"):
    cfg = get_smoke_config(arch).replace(vocab_size=254, dtype="float32")
    if arch == "qwen3-1.7b":
        cfg = cfg.replace(num_layers=2)
    base, sp = DenseTransformer(cfg, pc), SeqParallelDenseTransformer(cfg, pc, mesh=mesh)
    rng = np.random.RandomState(0)
    ps = jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32),
                      sp.abstract_params())
    lay, b = base.layout, dict(ps["blocks"])
    G, Pg, D = sp.n_groups, sp.group, cfg.d_model
    H, hd = cfg.num_heads, cfg.head_dim
    b["wq"] = pack_q_weight(ps["blocks"]["wq"], lay, head_axis=3).reshape(
        G, Pg, D, lay.kv_slots, lay.q_per_slot, hd)
    b["wk"] = pack_kv_weight(ps["blocks"]["wk"], lay, head_axis=3)
    b["wv"] = pack_kv_weight(ps["blocks"]["wv"], lay, head_axis=3)
    b["wo"] = pack_q_weight(ps["blocks"]["wo"].reshape(G, Pg, H, hd, D), lay,
                            head_axis=2).reshape(G, Pg, lay.kv_slots, lay.q_per_slot, hd, D)
    pb = dict(ps, blocks=b)
    B, S, MAX = 2, 12, 16
    toks = jnp.asarray(rng.randint(0, cfg.vocab_size, (B, S)), jnp.int32)
    lens = jnp.asarray([12, 7], jnp.int32)
    _, cache_b = base.prefill(jax.tree.map(jnp.asarray, pb), toks, seq_lens=lens, max_len=MAX)
    cache_sp = reshard_cache_from_packed(cache_b, base, sp)
    tok1 = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
    tok2 = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
    step = jax.jit(sp.decode_step)
    psj = jax.tree.map(jnp.asarray, ps)
    hlo = step.lower(psj, cache_sp, jnp.asarray(tok1), lens).compile().as_text()
    for kind, n in collective_stats(hlo).counts.items():
        out[f"sp/{arch}/gspmd/{kind}"] = np.int32(n)
    lg1, c1 = step(psj, cache_sp, jnp.asarray(tok1), lens)
    lg2, c2 = step(psj, c1, jnp.asarray(tok2), lens + 1)
    key = f"sp/{arch}"
    out.update({k: np.asarray(v) for k, v in flat(ps, key + "/params")})
    out.update({k: np.asarray(v) for k, v in flat(cache_b, key + "/cache_b")})
    out.update({k: np.asarray(v) for k, v in flat(c2, key + "/cache2")})
    out.update({key + "/pos": np.asarray(lens), key + "/tok1": tok1,
                key + "/tok2": tok2, key + "/lg1": np.asarray(lg1),
                key + "/lg2": np.asarray(lg2)})

# -- local expert parallelism with capacity drops: 6 experts padded to 8
rng = np.random.RandomState(1)
T, D, F, E, Ep, K = 32, 16, 24, 6, 8, 2
x = rng.randn(T, D).astype(np.float32)
router = rng.randn(D, E).astype(np.float32)
x[:, 0] = np.abs(x[:, 0]) + 2.0        # skew the router to experts 0 and 1:
router[0, :2] = (2.0, 1.5)             # their slots overflow capacity
mask = (np.arange(Ep) < E).astype(np.float32)[:, None, None]
wg, wu = (0.2 * rng.randn(Ep, D, F).astype(np.float32) * mask for _ in range(2))
wd = 0.2 * rng.randn(Ep, F, D).astype(np.float32) * mask
o, aux = jax.jit(lambda *a: moe_dispatch_local_ep(
    *a, top_k=K, capacity_factor=1.0, act="silu", mesh=mesh, pc=pc))(x, router, wg, wu, wd)
out.update({"ep/x": x, "ep/router": router, "ep/wg": wg, "ep/wu": wu,
            "ep/wd": wd, "ep/out": np.asarray(o), "ep/top_k": np.int32(K)})
c24 = coords(mesh)
for sh in aux.addressable_shards:
    out[f"ep/aux/{c24[sh.device.id]}"] = np.asarray(sh.data)

# -- placement of granite's params, ZeRO-1 master and cache at (2, 4), (2, 2, 2)
for name, shape, names in (("24", (2, 4), ("data", "model")),
                           ("222", (2, 2, 2), ("pod", "data", "model"))):
    m = compat_make_mesh(shape, names)
    pcm = ParallelConfig.from_mesh(m)
    model = build_model(get_smoke_config("granite-moe-3b-a800m").replace(dtype="float32"), pcm)
    params = model.init_params(jax.random.PRNGKey(1))
    specs = model.param_specs()
    rng = np.random.RandomState(2)
    cache = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                         model.cache_struct(8, 16))
    trees = {"params": (params, specs),
             "master": (params, opt_state_specs(specs, model.abstract_params(), pcm)["master"]),
             "cache": (cache, model.cache_specs())}
    cm = coords(m)
    isp = lambda s: isinstance(s, P)
    for tname, (tree, tspecs) in trees.items():
        leaves = dict(flat(tree, f"place/{name}/{tname}"))
        lspecs = dict(flat(tspecs, f"place/{name}/{tname}", is_leaf=isp))
        for path, leaf in leaves.items():
            arr = jax.device_put(leaf, NamedSharding(m, lspecs[path]))
            out[path + "/full"] = np.asarray(leaf)
            for sh in arr.addressable_shards:
                out[f"{path}/{cm[sh.device.id]}"] = np.asarray(sh.data)

# -- JAX refuses an uneven input sharding
try:
    jax.jit(lambda a: a * 2, in_shardings=NamedSharding(mesh, P("model", None)))(
        np.zeros((6, 4), np.float32))
    out["uneven_refused"] = np.bool_(False)
except ValueError:
    out["uneven_refused"] = np.bool_(True)

np.savez(sys.argv[1], **out)
print("WROTE", len(out))
"""

WORLD_DEADLINE_S = 200     # under pytest.ini's 300 s per test


def _run_world(workdir, npz):
    """8 spawned ranks of tests/_torch_mesh_worker.py (``main``); see
    ``_torch_mesh_worker.spawn``."""
    import _torch_mesh_worker as worker
    return worker.spawn(workdir, npz, worker.main, WORLD_DEADLINE_S)


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """The JAX package's values at (2, 4) and (2, 2, 2) from one process with
    8 host devices, then the port's 8-rank gloo world on them."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    workdir = tmp_path_factory.mktemp("mesh_world")
    npz = workdir / "ref.npz"
    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_MESH_SCRIPT, str(npz)],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(npz), _run_world(workdir, npz)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b"])
def test_seq_parallel_decode_on_a_gloo_mesh_equals_the_reference(mesh_world, arch):
    """Two sequence-parallel decode steps at (2, 4) from JAX's prefill cache
    (resharded by reshard_cache_from_packed), the second reading the first's
    cache write (gemma3: window layers whose ring wraps), equal JAX's at (2,
    4) to 1e-5 of the largest logit in float32; the caches after them too."""
    _, ranks = mesh_world
    for r in ranks:
        got = r["sp"][arch]
        assert got["err1"] < 1e-5 and got["err2"] < 1e-5, got
        assert got["cache_err"] < 1e-5 and got["pad_masked"], got
        # the port's collective calls per step: five all-reduces per layer
        # (QKV partials, the merge's max and its sums, o-projection, MLP),
        # the embedding's all-reduce and the logits' all-gather. The
        # reference's compiled step (XLA:CPU, after its combiner passes) is
        # recorded beside them in "gspmd" (PERF.md §6 cites both)
        L = 2 if arch == "qwen3-1.7b" else 6
        assert got["collectives"] == {"all_reduce": 5 * L + 1,
                                      "all_gather_into_tensor": 1}, got
        assert sum(got["gspmd"].values()) > 0, got
        # each rank holds a quarter of the sequence: 16 // 4, the rings 8 // 4
        assert got["local_seq"] == dict(
            {"k_full": 4, "v_full": 4},
            **({"k_win": 2, "v_win": 2} if arch == "gemma3-12b" else {}))


def test_local_ep_dispatch_with_drops_equals_the_reference(mesh_world):
    """moe_dispatch_local_ep at (2, 4), 6 experts padded to 8, capacity
    factor 1 with a skewed router so that slots drop: every rank's output
    rows equal JAX's to 1e-5, and its aux equals the JAX device's at the
    same coordinate. That aux is the model-axis mean of the rank's own data
    shard, so the two data shards read different values though the
    reference declares the output replicated (ROADMAP §3, known)."""
    _, ranks = mesh_world
    assert sum(r["ep"]["dropped"] for r in ranks) > 0
    for r in ranks:
        assert r["ep"]["err"] < 1e-5, r["ep"]
        assert abs(r["ep"]["aux"] - r["ep"]["aux_jax"]) < 1e-6 * r["ep"]["aux_jax"]
    by_data = {r["coord24"][0]: r["ep"]["aux_jax"] for r in ranks}
    assert by_data[0] != by_data[1]


@pytest.mark.parametrize("mesh", ["24", "222"])
def test_placed_shards_equal_the_reference_bit_for_bit(mesh_world, mesh):
    """granite's smoke params (kv slots, vocab, experts on the model axis),
    their ZeRO-1 master (plus a DP axis) and a cache (batch over the DP
    axes): every rank's local shard equals, bit for bit and in shape, the
    addressable shard of the JAX device at the same mesh coordinate."""
    _, ranks = mesh_world
    for r in ranks:
        assert r["place"][mesh]["leaves"] == 26 and not r["place"][mesh]["bad"], r["place"]


def test_jax_refuses_an_uneven_sharding_and_so_does_the_port(mesh_world):
    ref, _ = mesh_world
    assert bool(ref["uneven_refused"])
    with pytest.raises(ValueError, match="uneven"):
        TS.placements(TS.PartitionSpec("model", None), _Mesh((2, 4), ("data", "model")),
                      (6, 4))


def test_moe_model_with_local_ep_on_a_gloo_mesh_equals_one_device(mesh_world):
    """granite's smoke MoETransformer at (2, 4) with model.mesh set: each rank
    prefills and decodes its data shard's rows with its 2 of 8 experts, and
    equals the single-device model to 1e-5 (capacity set so nothing drops)."""
    _, ranks = mesh_world
    for r in ranks:
        got = r["moe_model"]
        assert got["prefill_err"] < 1e-5 and got["decode_err"] < 1e-5, got
        assert (got["local_experts"], got["padded_experts"]) == (2, 8)


def test_zero1_adamw_on_a_gloo_mesh_equals_one_device(mesh_world):
    """Two AdamW steps on state placed by opt_state_specs at (2, 4), gradients
    Partial over data (reduce-scattered to the state): params, m, v and
    master equal the single-device steps to 1e-6; local state shards have
    the shapes of JAX's at the same coordinate; params return to their own
    placement."""
    _, ranks = mesh_world
    for r in ranks:
        z = r["zero1"]
        assert max(z["err"].values()) < 1e-6, z
        assert all(abs(a - b) <= 1e-6 * a for a, b in z["norms"]), z
        assert z["shapes_ok"] and z["params_placed"] and z["step"] == 2
        assert z["dp_sharded_leaves"] > 0


def test_elastic_restore_moves_a_checkpoint_between_gloo_meshes(mesh_world):
    """A bf16 checkpoint written by fault_tolerance, elastic_restore'd onto
    (2, 4) then (4, 2): the full tensors keep its bits; the other tree
    passes through."""
    _, ranks = mesh_world
    for r in ranks:
        e = r["elastic"]
        assert (e["24"]["tp"], e["42"]["tp"]) == (4, 2)
        for k in ("24", "42"):
            assert e[k]["same_bits"] and e[k]["opt_passes"] and e[k]["sharded"] > 0


def test_gloo_ranks_import_neither_jax_nor_repro(mesh_world):
    _, ranks = mesh_world
    assert all(r["imported"] == [] for r in ranks)


# --------------------------------------------------------------------------
# the whole-model tensor-parallel forward: the port's cells against the
# reference's at (2, 4) and (2, 2, 2)
# --------------------------------------------------------------------------
import _torch_mesh_worker as worker  # noqa: E402

TP_MESHES = ["24", "222"]


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """The reference's cells jitted on its (2, 4) and (2, 2, 2) meshes of 8
    host devices (one JAX process per mesh), then the port's cells on the
    same weights and inputs in an 8-rank gloo world (``main_tp``)."""
    return worker.tp_world(tmp_path_factory.mktemp("tp_world"), TP_MESHES,
                           WORLD_DEADLINE_S)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.TP_CASES)
def test_tp_cells_on_a_gloo_mesh_equal_the_reference_cells(tp_world, arch, mesh):
    """See ``_torch_mesh_worker.check_tp_cells``."""
    worker.check_tp_cells(tp_world, arch, mesh)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.TP_CASES)
def test_tp_collective_calls_per_step(tp_world, arch, mesh):
    """At (2, 4) one DP axis, at (2, 2, 2) two: see
    ``_torch_mesh_worker.check_tp_calls``."""
    worker.check_tp_calls(tp_world, arch, mesh)


def test_tp_ranks_import_neither_jax_nor_repro(tp_world):
    assert all(r["imported"] == [] for r in tp_world)


# --------------------------------------------------------------------------
# the other families' TP forward, the fully sharded train cells and
# compressed gradients: a second world, so that each stays inside its limits
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def families_world(tmp_path_factory):
    """The reference's cells of ``FAMILY_CASES``, its fsdp cells and its
    compressed-gradient cell jitted (one JAX process per mesh), then the
    port's in an 8-rank gloo world (``_torch_mesh_worker.tp_world``)."""
    return worker.tp_world(tmp_path_factory.mktemp("families_world"), TP_MESHES,
                           WORLD_DEADLINE_S, world="families")


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.FAMILY_CASES)
def test_family_tp_cells_on_a_gloo_mesh_equal_the_reference_cells(families_world,
                                                                  arch, mesh):
    """See ``_torch_mesh_worker.check_family_cells``."""
    worker.check_family_cells(families_world, arch, mesh)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.FAMILY_CASES)
def test_family_tp_collective_calls_per_step(families_world, arch, mesh):
    """See ``_torch_mesh_worker.check_family_calls``."""
    worker.check_family_calls(families_world, arch, mesh)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.FSDP_ARCHS)
def test_fsdp_train_cells_on_a_gloo_mesh_equal_the_reference_cells(families_world,
                                                                   arch, mesh):
    """See ``_torch_mesh_worker.check_fsdp``."""
    worker.check_fsdp(families_world, arch, mesh)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", worker.FSDP_ARCHS)
def test_fsdp_collective_calls_per_step(families_world, arch, mesh):
    """See ``_torch_mesh_worker.check_fsdp_calls``."""
    worker.check_fsdp_calls(families_world, arch, mesh)


def test_compressed_gradients_on_a_gloo_mesh_equal_the_reference_cell(families_world):
    """See ``_torch_mesh_worker.check_compress``."""
    worker.check_compress(families_world)


def test_family_ranks_import_neither_jax_nor_repro(families_world):
    assert all(r["imported"] == [] for r in families_world)


_BUILD_EVERY_CELL = r"""
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.launch.cells import abstract_args, build_cell
from repro_torch.launch.mesh import fake_world

built, skipped = [], []
with fake_world(8):
    meshes = {"1": None,
              "2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2),
                                        mesh_dim_names=("pod", "data", "model"))}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            if not cfg.supports_shape(shape):
                skipped.append([arch, shape.name])
                continue
            opts = ([("tp", False), ("tp", True), ("fsdp", False), ("fsdp", True)]
                    if shape.kind == "train" else [("tp", False)])
            for name, mesh in meshes.items():
                for layout, compress in opts:
                    cell = build_cell(arch, shape.name, mesh, train_layout=layout,
                                      compress_grads=compress)
                    # every argument placed: no uneven shard anywhere
                    with FakeTensorMode(allow_non_fake_inputs=True):
                        abstract_args(cell, "cpu")
                    built.append([arch, shape.name, name, layout, compress,
                                  cell.pc.tp, cell.pc.dp])
print("BUILT " + json.dumps({"built": built, "skipped": skipped}))
"""


def test_build_cell_builds_every_cell_on_both_meshes_in_both_layouts():
    """``build_cell`` builds every arch at every shape it supports at full
    size, at mesh None and on fake (2, 4) and (2, 2, 2) worlds, a train
    shape with ``train_layout`` "tp" and "fsdp" and ``compress_grads`` off
    and on, as the reference's does, and places each cell's arguments. The
    fsdp cells put every mesh axis on the batch; the others the model axis
    on the heads (long_500k's one row: no data axis)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import ALL_SHAPES

    src = str(Path(__file__).resolve().parent.parent / "src")
    proc = subprocess.run([sys.executable, "-c", _BUILD_EVERY_CELL],
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("BUILT")][0]
    out = json.loads(line.split(" ", 1)[1])
    supported = [(a, s.name, s.kind) for a in ARCH_IDS for s in ALL_SHAPES
                 if get_config(a).supports_shape(s)]
    assert len(supported) + len(out["skipped"]) == 4 * len(ARCH_IDS)
    assert all(s == "long_500k" for _, s in out["skipped"])
    assert len(out["built"]) == 3 * sum(4 if k == "train" else 1
                                        for _, _, k in supported)
    for arch, shape, mesh, layout, _, tp, dp in out["built"]:
        if mesh == "1":
            assert (tp, dp) == (1, 1)
        elif layout == "fsdp":
            assert (tp, dp) == (1, 8)
        else:
            assert tp == (4 if mesh == "2x4" else 2)
            assert dp == (1 if shape == "long_500k" else 8 // tp)
