"""``repro_torch.models.transformer.DenseTransformer`` against the JAX
``DenseTransformer`` on the same weights, carried across by
``repro_torch.bridge``, on the qwen3-1.7b smoke config (qk_norm) and the
qwen2-0.5b smoke config (qkv_bias, 3 heads over 1 kv head).

float32 logits and caches are held to 1e-4: two layers of float32 products
whose sums the two frameworks order differently. bfloat16 is compared loosely
(5e-2 of the largest logit): the frameworks round intermediate products at
different places. Inside the port, dense decode and paged decode through the
gathered-page recipe (``attn_impl='ref'``) are bit-identical.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-0.5b"]
F32_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str):
    """(jax model, jax params, port model, port params) on the same weights.
    The zero-initialised norm scales and biases get random values so that
    the qk-norm and qkv-bias paths do real work."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype=dtype))
    jp = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    blocks = dict(jp["blocks"])
    for name in ("ln1", "ln2", "q_norm", "k_norm", "bq", "bk", "bv"):
        if name in blocks:
            noise = 0.1 * rng.randn(*blocks[name].shape).astype(np.float32)
            blocks[name] = jnp.asarray(noise).astype(blocks[name].dtype)
    jp = dict(jp, blocks=blocks)
    tm = build_model(get_smoke_config(arch).replace(dtype=dtype))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _prompt(cfg, B=3, L=16, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    lens = np.array([L, L - 5, 3][:B], np.int32)
    return toks, lens


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_bridge_carries_bf16_bits_exactly():
    x = jnp.asarray(np.random.RandomState(0).randn(5, 7).astype(np.float32)
                    ).astype(jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_templates_match_the_reference(arch):
    """Same tree, shapes and zero pad-slot structure as the JAX init."""
    jm, jp, tm, _ = _pair(arch, "float32")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(prefix + f"['{k}']", v)
            else:
                flat_t[prefix + f"['{k}']"] = v
    walk("", tp)
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
    assert tm.param_count() == jm.param_count()
    pad = tm.layout.q_array() < 0
    assert bool((tp["blocks"]["wq"][..., torch.from_numpy(pad), :] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks, lens = _prompt(tm.cfg)
    max_len = 32
    jl, jc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens),
                        max_len=max_len)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), seq_lens=torch.from_numpy(lens),
                        max_len=max_len)
    if dtype == "float32":
        _close(tl, jl, F32_TOL)
        for name in ("k_full", "v_full"):
            _close(tc[name], jc[name], F32_TOL)
    else:
        scale = float(np.abs(np.asarray(jl, np.float32)).max())
        _close(tl, jl, 5e-2 * scale)

    # one decode step on the prefill caches, dense and paged
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens))
    td, _ = tm.decode_step(tp, {k: v.clone() for k, v in tc.items()},
                           torch.from_numpy(nxt), torch.from_numpy(lens))
    if dtype == "float32":
        _close(td, jd, F32_TOL)
    else:
        scale = float(np.abs(np.asarray(jd, np.float32)).max())
        _close(td, jd, 5e-2 * scale)


def _paged_setup(tm, tc, B, max_len, bs):
    """Scatter dense prefill caches into pools through shuffled tables."""
    nblk = max_len // bs
    num_blocks = B * nblk + 1
    perm = np.random.RandomState(9).permutation(B * nblk).astype(np.int32)
    tables = perm.reshape(B, nblk)
    pools = tm.init_paged_pools(num_blocks, bs)
    tm.scatter_prefill_pools(pools, tc, torch.from_numpy(tables))
    return pools, tables


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax_and_dense(arch):
    jm, jp, tm, tp = _pair(arch, "float32")
    toks, lens = _prompt(tm.cfg)
    B, max_len, bs = toks.shape[0], 32, 8
    jl, jc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens),
                        max_len=max_len)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        seq_lens=torch.from_numpy(lens), max_len=max_len)
    nxt = tl.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens)
    ctx = pos + 1

    pools, tables = _paged_setup(tm, tc, B, max_len, bs)
    jpools = jm.init_paged_pools(B * (max_len // bs) + 1, bs)
    jpools = jm.scatter_prefill_pools(jpools, jc, jnp.asarray(tables))
    jd, jpools = jm.decode_step_paged(jp, jpools, jnp.asarray(nxt.numpy()),
                                      jnp.asarray(lens), jnp.asarray(tables),
                                      jnp.asarray(ctx.numpy()), attn_impl="ref")
    td, pools = tm.decode_step_paged(tp, pools, nxt, pos, torch.from_numpy(tables),
                                     ctx, attn_impl="ref")
    _close(td, jd, F32_TOL)
    for name in ("k", "v"):
        _close(pools[name], jpools[name], F32_TOL)

    # inside the port: paged 'ref' decode is bit-identical to dense decode
    dense, _ = tm.decode_step(tp, {k: v.clone() for k, v in tc.items()}, nxt, pos)
    assert torch.equal(td, dense)

    # the kernel path (its plain version on CPU tensors) agrees in float32
    pools2, _ = _paged_setup(tm, tc, B, max_len, bs)
    tk, _ = tm.decode_step_paged(tp, pools2, nxt, pos, torch.from_numpy(tables),
                                 ctx, attn_impl="kernel")
    _close(tk, td.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_prefill_path_matches_block(arch):
    """with_prefill_attn('flash') (the kernel's plain version on the CPU)
    against the blockwise path, float32."""
    _, _, tm, tp = _pair(arch, "float32")
    toks, lens = _prompt(tm.cfg)
    bl, bc = tm.prefill(tp, torch.from_numpy(toks), seq_lens=torch.from_numpy(lens))
    fl, fc = tm.with_prefill_attn("flash").prefill(
        tp, torch.from_numpy(toks), seq_lens=torch.from_numpy(lens))
    _close(fl, bl.numpy(), 1e-5)
    # caches agree on the valid positions (pad rows attend differently: the
    # flash path masks causally only, and their values are never read)
    for name in ("k_full", "v_full"):
        for b, n in enumerate(lens):
            _close(fc[name][:, :, b, :n], bc[name][:, :, b, :n].numpy(), 1e-5)


def test_unported_archs_and_families_raise():
    from repro_torch.configs import get_config

    with pytest.raises(KeyError, match="not ported"):
        get_config("gemma3-12b")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(get_smoke_config("qwen3-1.7b").replace(family="moe"))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(get_smoke_config("qwen3-1.7b").replace(
            attn_kind="local_global", local_global_pattern=1))
