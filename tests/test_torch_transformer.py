"""The port's models against the JAX package's on the same weights, carried
across by ``repro_torch.bridge``: ``DenseTransformer`` on the qwen3-1.7b
smoke config (qk_norm) and the qwen2-0.5b smoke config (qkv_bias, 3 heads
over 1 kv head), and ``RWKV6Model`` on the rwkv6-7b smoke config.

float32 logits and caches are held to 1e-4: two layers of float32 products
whose sums the two frameworks order differently. bfloat16 is compared loosely
(5e-2 of the largest logit): the frameworks round intermediate products at
different places. Inside the port, dense decode and paged decode through the
gathered-page recipe (``attn_impl='ref'``) are bit-identical.

RWKV6 prefill and decode logits and all three caches are held to 1e-4 of
the largest value in float32 and 2e-2 in bfloat16 (the bound of
tests/test_decode_consistency.py).
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.rwkv6 import RWKV6Model  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-0.5b"]
RWKV = "rwkv6-7b"
F32_TOL = 1e-4
# zero-initialised params that get random values, so every path does work
NOISE = {"ln1": 0.1, "ln2": 0.1, "q_norm": 0.1, "k_norm": 0.1, "bq": 0.1,
         "bk": 0.1, "bv": 0.1,
         # RWKV6
         "ln1_b": 0.3, "ln2_b": 0.3, "mu_base": 0.3, "mu": 0.3, "lora_b": 0.3,
         "w0": 0.3, "wd2": 0.3, "bonus": 0.3, "mu_ck": 0.3, "mu_cr": 0.3}


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str):
    """(jax model, jax params, port model, port params) on the same weights.
    The zero-initialised norm scales, biases, mixes and decays get random
    values so that the qk-norm, qkv-bias and RWKV6 lora paths do real work."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype=dtype))
    jp = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    blocks = dict(jp["blocks"])
    for name, scale in NOISE.items():
        if name in blocks:
            noise = scale * rng.randn(*blocks[name].shape).astype(np.float32)
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


# ----------------------------------------------------------------------------
# RWKV6Model
# ----------------------------------------------------------------------------
def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)


def _rwkv_tokens(cfg, B=3, L=32, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    lens = np.array([L, L - 7, 5][:B], np.int32)
    return toks, lens


def test_rwkv6_registry_templates_and_bridge():
    """``build_model`` maps the ssm family to RWKV6Model, its init has the
    reference's tree and shapes, and ``params_from_numpy`` carries the JAX
    weights across bit for bit in bf16."""
    jm, jp, tm, tp = _pair(RWKV, "bfloat16")
    assert isinstance(tm, RWKV6Model)
    assert tm.param_count() == jm.param_count()
    own = tm.init_params(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict) else {key: v})
        return out

    flat_own, flat_tp = flat(own), flat(tp)
    assert set(flat_own) == set(flat_j) == set(flat_tp)
    for key, arr in flat_j.items():
        assert tuple(flat_own[key].shape) == arr.shape, key
        assert flat_own[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(flat_tp[key].view(torch.int16).numpy(),
                                      np.asarray(arr).view(np.int16))
    # norm scales start at one, as the reference's "ones" init
    assert torch.equal(own["blocks"]["gn"], torch.ones_like(own["blocks"]["gn"]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("padded", [False, True])
def test_rwkv6_prefill_and_decode_match_jax(dtype, tol, padded):
    jm, jp, tm, tp = _pair(RWKV, dtype)
    toks, lens = _rwkv_tokens(tm.cfg)
    sl_t = torch.from_numpy(lens) if padded else None
    sl_j = jnp.asarray(lens) if padded else None
    lg, cache = tm.prefill(tp, torch.from_numpy(toks), seq_lens=sl_t)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks), seq_lens=sl_j)
    assert _rel_err(lg.float().numpy(), jlg) < tol
    assert set(cache) == {"state", "tm_shift", "cm_shift"}
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert cache[name].dtype == (torch.float32 if name == "state"
                                     else tm.dtype)
        assert _rel_err(cache[name].float().numpy(), jcache[name]) < tol, name
    nxt = lg.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens if padded else np.full(3, toks.shape[1], np.int32))
    d, cache = tm.decode_step(tp, cache, nxt, pos)
    jd, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt.numpy()),
                                jnp.asarray(pos.numpy()))
    assert _rel_err(d.float().numpy(), jd) < tol
    for name in cache:
        assert _rel_err(cache[name].float().numpy(), jcache[name]) < tol, name


def test_rwkv6_decode_matches_prefill():
    """Port mirror of tests/test_decode_consistency.py::test_decode_matches_prefill
    on the bf16 smoke config."""
    cfg = get_smoke_config(RWKV)
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(1))
    B, S = 2, 16
    tk = torch.randint(0, cfg.vocab_size, (B, S + 1),
                       generator=torch.Generator().manual_seed(2))
    _, cache = m.prefill(params, tk[:, :S], max_len=S + 4)
    lg, _ = m.decode_step(params, cache, tk[:, S], torch.full((B,), S))
    want, _ = m.prefill(params, tk[:, :S + 1], max_len=S + 5)
    assert _rel_err(lg.float().numpy(), want.float().numpy()) < 0.02


def test_rwkv6_padded_prefill_matches_exact():
    """Port mirror of tests/test_decode_consistency.py::
    test_padded_prefill_matches_exact on the bf16 smoke config."""
    cfg = get_smoke_config(RWKV)
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(1))
    B, n, pad_to = 2, 13, 32
    tk = torch.randint(0, cfg.vocab_size, (B, n + 1),
                       generator=torch.Generator().manual_seed(3))
    sl = torch.full((B,), n, dtype=torch.int32)
    toks_p = torch.zeros((B, pad_to), dtype=torch.long)
    toks_p[:, :n] = tk[:, :n]
    lg_pad, cache = m.prefill(params, toks_p, seq_lens=sl, max_len=64)
    lg_exact, _ = m.prefill(params, tk[:, :n], max_len=64)
    assert _rel_err(lg_pad.float().numpy(), lg_exact.float().numpy()) < 1e-2
    lg_d, _ = m.decode_step(params, cache, tk[:, n], sl)
    lg_ref, _ = m.prefill(params, tk[:, :n + 1], max_len=64)
    assert _rel_err(lg_d.float().numpy(), lg_ref.float().numpy()) < 0.02


@pytest.mark.parametrize("L,chunk", [(32, 16), (256, 16), (4096, 32)])
@pytest.mark.parametrize("padded", [False, True])
def test_rwkv6_prefill_makes_one_wkv_call_per_layer(monkeypatch, L, chunk,
                                                    padded):
    """Each layer's prefill hands the whole sequence to ``ops.rwkv6_chunk``
    once, with the model's chunk length (the chunk loop runs inside it)."""
    cfg = get_smoke_config(RWKV).replace(dtype="float32")
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(4))
    calls = []
    real = ops.rwkv6_chunk

    def counting(r, *args, **kw):
        calls.append((tuple(r.shape), kw.get("chunk")))
        return real(r, *args, **kw)

    monkeypatch.setattr(ops, "rwkv6_chunk", counting)
    toks = torch.randint(0, cfg.vocab_size, (1, L),
                         generator=torch.Generator().manual_seed(5))
    sl = torch.tensor([L - 9], dtype=torch.int32) if padded else None
    lg, _ = m.prefill(params, toks, seq_lens=sl)
    assert bool(torch.isfinite(lg).all())
    H, K = m.n_heads, cfg.rwkv_head_dim
    assert calls == [((1, L, H, K), chunk)] * cfg.num_layers


def test_rwkv6_plain_and_kernel_impls_agree_on_cpu():
    """``with_wkv_impl`` switches the chunk path; on CPU tensors both run the
    plain version, so the logits are identical."""
    _, _, tm, tp = _pair(RWKV, "float32")
    toks, _ = _rwkv_tokens(tm.cfg)
    a, _ = tm.with_wkv_impl("plain").prefill(tp, torch.from_numpy(toks))
    b, _ = tm.with_wkv_impl("kernel").prefill(tp, torch.from_numpy(toks))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="WKV impl"):
        tm.with_wkv_impl("pallas")
