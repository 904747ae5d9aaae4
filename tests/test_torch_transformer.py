"""The port's models against the JAX package's on the same weights, carried
across by ``repro_torch.bridge``: ``DenseTransformer`` on the qwen3-1.7b
smoke config (qk_norm) and the qwen2-0.5b smoke config (qkv_bias, 3 heads
over 1 kv head), and ``RWKV6Model`` on the rwkv6-7b smoke config.

The MoE family (``MoETransformer``, ``moe_dispatch``) and the rest of the
dense family (gemma3's local:global layers with ring-buffer window caches,
qwen2.5-32b, the internvl2 backbone with ``extra_embeds``) are held tighter,
to 1e-5 in float32, prefill and every decode step past the window's wrap.

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
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
NEW_ARCHS = MOE_ARCHS + ["gemma3-12b", "qwen2.5-32b", "internvl2-26b"]
# the full-attention archs: every one but gemma3 takes the paged backend
PAGED_ARCHS = ARCHS + MOE_ARCHS + ["qwen2.5-32b", "internvl2-26b"]
NEW_F32_TOL = 1e-5
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


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
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


@pytest.mark.parametrize("arch", PAGED_ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
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
    # flash path masks causally only, and their values are never read); the
    # window rings hold valid positions only
    assert fc.keys() == bc.keys()
    for name in fc:
        if name.endswith("_win"):
            _close(fc[name], bc[name].numpy(), 1e-5)
            continue
        for b, n in enumerate(lens):
            _close(fc[name][:, :, b, :n], bc[name][:, :, b, :n].numpy(), 1e-5)


def test_unported_archs_and_families_raise():
    from repro_torch.configs import get_config

    for arch in ("hymba-1.5b", "whisper-base"):
        with pytest.raises(KeyError, match="not ported"):
            get_config(arch)
    for family in ("hybrid", "audio"):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(get_smoke_config("qwen3-1.7b").replace(family=family))


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


# ----------------------------------------------------------------------------
# the MoE family and the rest of the dense family
# ----------------------------------------------------------------------------
def test_build_model_takes_every_new_arch_at_full_width():
    """``build_model(get_config(a))`` for each new arch, with the reference's
    parameter count (templates only: nothing is allocated)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoETransformer
    from repro_torch.models.transformer import DenseTransformer

    for arch in NEW_ARCHS:
        m = build_model(get_config(arch))
        assert isinstance(m, MoETransformer if arch in MOE_ARCHS
                          else DenseTransformer), arch
        assert m.param_count() == jax_build_model(
            jax_get_config(arch)).param_count(), arch
    gemma = build_model(get_config("gemma3-12b"))
    assert (gemma.group, gemma.n_full, gemma.n_win) == (6, 1, 5)
    assert not gemma.supports_paged()


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_archs_prefill_and_ten_decode_steps_match_jax(arch, dtype):
    """Prefill (ragged, padded to 16, caches of 32) then ten greedy decode
    steps in lockstep with the JAX model: gemma3's prompts of 16 and 11
    already wrap its 8-token window ring, and decoding wraps it again."""
    jm, jp, tm, tp = _pair(arch, dtype)
    toks, lens = _prompt(tm.cfg)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens),
                        max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        seq_lens=torch.from_numpy(lens), max_len=32)
    assert tc.keys() == jc.keys()
    f32 = dtype == "float32"
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, NEW_F32_TOL if f32 else 5e-2 * scale)
    if f32:
        for name in tc:
            _close(tc[name], jc[name], NEW_F32_TOL)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = lens.copy()
    for _ in range(10 if f32 else 1):
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        td, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        scale = float(np.abs(np.asarray(jd, np.float32)).max())
        _close(td, jd, NEW_F32_TOL if f32 else 5e-2 * scale)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
        pos = pos + 1
    if f32:
        for name in tc:
            _close(tc[name], jc[name], NEW_F32_TOL)


def test_internvl2_extra_embeds_prefill_matches_jax():
    """The VLM backbone with patch embeddings prepended (8 patches, as the
    smoke config's ``num_vision_patches``): prefill logits and caches, then
    one decode step, float32."""
    jm, jp, tm, tp = _pair("internvl2-26b", "float32")
    toks, lens = _prompt(tm.cfg)
    P = tm.cfg.num_vision_patches
    emb = 0.5 * np.random.RandomState(7).randn(
        toks.shape[0], P, tm.cfg.d_model).astype(np.float32)
    lens = lens + P
    jl, jc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens),
                        max_len=32, extra_embeds=jnp.asarray(emb))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        seq_lens=torch.from_numpy(lens), max_len=32,
                        extra_embeds=torch.from_numpy(emb))
    _close(tl, jl, NEW_F32_TOL)
    for name in tc:
        _close(tc[name], jc[name], NEW_F32_TOL)
    # the patches change the logits: they are not ignored
    plain, _ = tm.prefill(tp, torch.from_numpy(toks))
    assert not torch.allclose(tl, plain)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens))
    td, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), torch.from_numpy(lens))
    _close(td, jd, NEW_F32_TOL)


def test_gemma3_padded_prefill_matches_exact():
    """Port mirror of tests/test_decode_consistency.py::
    test_padded_prefill_matches_exact on the bf16 gemma3 smoke config: a
    13-token prompt padded to 32 (past the 8-token window) against the exact
    prefill, then a decode step from the padded prefill's ring caches."""
    cfg = get_smoke_config("gemma3-12b")
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(1))
    B, n, pad_to = 2, 13, 32
    tk = torch.randint(0, cfg.vocab_size, (B, n + 1),
                       generator=torch.Generator().manual_seed(3))
    sl = torch.full((B,), n, dtype=torch.int32)
    toks_p = torch.zeros((B, pad_to), dtype=torch.long)
    toks_p[:, :n] = tk[:, :n]
    lg_pad, cache = m.prefill(params, toks_p, seq_lens=sl, max_len=64)
    lg_exact, exact = m.prefill(params, tk[:, :n], max_len=64)
    assert _rel_err(lg_pad.float().numpy(), lg_exact.float().numpy()) < 1e-2
    assert cache["k_win"].shape[3] == cfg.sliding_window
    lg_d, _ = m.decode_step(params, cache, tk[:, n], sl)
    lg_ref, _ = m.prefill(params, tk[:, :n + 1], max_len=64)
    assert _rel_err(lg_d.float().numpy(), lg_ref.float().numpy()) < 0.02


def test_gemma3_has_no_paged_pools():
    _, _, tm, _ = _pair("gemma3-12b", "float32")
    assert not tm.supports_paged()
    with pytest.raises(NotImplementedError, match="full-attention archs only"):
        tm.init_paged_pools(9, 8)


def _moe_inputs(T=32, D=16, F=24, E=8, seed=0):
    """Tokens that share a component the router favours expert 0 for, so
    that expert 0 gets more than its capacity at cf 1.25 (C 16 for 64
    slots over 8 experts)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, D) + 1.0).astype(np.float32)
    router = rng.randn(D, E).astype(np.float32)
    router[:, 0] += 0.5
    ws = [(0.2 * rng.randn(*shape)).astype(np.float32)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, router] + ws


def _jax_drops(x, router, top_k, cf):
    """The slots the reference drops, [T, k], by its own steps
    (repro/models/moe.py::moe_dispatch: top-k, stable sort by expert, rank
    within the expert, rank >= C)."""
    from repro.distributed.sharding import round_up

    T, E = x.shape[0], router.shape[1]
    probs = jax.nn.softmax((jnp.asarray(x) @ jnp.asarray(router)), axis=-1)
    _, top_i = jax.lax.top_k(probs, top_k)
    eid = top_i.reshape(-1)
    order = jnp.argsort(eid, stable=True)
    eid_s = eid[order]
    first = jnp.searchsorted(eid_s, jnp.arange(E, dtype=eid_s.dtype))
    rank = jnp.arange(T * top_k) - first[eid_s]
    C = int(round_up(max(8, int(np.ceil(T * top_k / E * cf))), 8))
    drop_s = np.asarray(rank >= C)
    drop = np.zeros(T * top_k, bool)
    drop[np.asarray(order)] = drop_s
    return drop.reshape(T, top_k)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_dispatch_matches_jax(cf):
    """T 32, E 8, k 2, float32: the output within 1e-5 of its scale, the same
    slots dropped past capacity (some at cf 1.25, none at cf 8) and the same
    aux loss."""
    from repro.models.moe import moe_dispatch as jax_moe_dispatch
    from repro_torch.models.moe import moe_dispatch, moe_route

    args = _moe_inputs()
    k = 2
    want, aux_j = jax_moe_dispatch(*map(jnp.asarray, args), top_k=k,
                                   capacity_factor=cf, act="silu")
    targs = [torch.from_numpy(a) for a in args]
    out, aux = moe_dispatch(*targs, top_k=k, capacity_factor=cf, act="silu")
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=1e-5 * scale, rtol=0)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)
    rt = moe_route(targs[0], targs[1], 8, top_k=k, capacity_factor=cf)
    drops = (rt.dest == 8 * rt.capacity).reshape(-1, k).numpy()
    np.testing.assert_array_equal(drops, _jax_drops(args[0], args[1], k, cf))
    assert drops.any() == (cf == 1.25)


def test_moe_top_k_ties_take_the_lower_expert_first():
    """A zero router makes every expert tie: top-k takes experts 0..k-1 in
    order, as jax.lax.top_k does, and the outputs agree."""
    from repro.models.moe import moe_dispatch as jax_moe_dispatch
    from repro_torch.models.moe import moe_dispatch, moe_route

    args = _moe_inputs(T=8)
    args[1] = np.zeros_like(args[1])
    rt = moe_route(torch.from_numpy(args[0]), torch.from_numpy(args[1]), 8,
                   top_k=3, capacity_factor=8.0)
    assert rt.top_i.tolist() == [[0, 1, 2]] * 8
    want, _ = jax_moe_dispatch(*map(jnp.asarray, args), top_k=3,
                               capacity_factor=8.0, act="silu")
    out, _ = moe_dispatch(*map(torch.from_numpy, args), top_k=3,
                          capacity_factor=8.0, act="silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------------------------
# rwkv6_chunk takes every chunk length the model passes on CUDA
# ----------------------------------------------------------------------------
def test_rwkv6_kernel_chunking_takes_only_the_kernels_chunks():
    """The chunk length the model passes on CUDA is one the kernel takes
    (``rwkv6_chunk.CHUNKS``) and divides the (padded) length, with less than
    one chunk of padding; where the reference's own ``_chunk_size`` is one of
    them, the model keeps it."""
    from repro_torch.kernels.rwkv6_chunk import CHUNKS
    from repro_torch.models.rwkv6 import _chunk_size, kernel_chunking

    for S in range(1, 20_000):
        c, padded = kernel_chunking(S)
        assert c in CHUNKS and padded % c == 0 and 0 <= padded - S < c, S
        if _chunk_size(S) in CHUNKS:
            assert (c, padded) == (_chunk_size(S), S), S
    assert _chunk_size(1000) == 8 and kernel_chunking(1000) == (16, 1008)
    assert _chunk_size(12288) == 96 and kernel_chunking(12288) == (64, 12288)


@pytest.mark.parametrize("S", [1000, 12288])
def test_rwkv6_padded_wkv_equals_the_reference_chunking(S):
    """What the model runs on CUDA at S 1000 (chunks of 16 over 1008 tokens,
    8 of them masked pads) and S 12288 (chunks of 64), here through the plain
    version, against the reference's own chunking (8 and 96): o and the
    state within 1e-4 of their largest value in float32, as the RWKV6 model
    tests hold them (other chunk lengths sum in other orders)."""
    from repro_torch.kernels import ref
    from repro_torch.models.rwkv6 import _chunk_size, wkv_padded

    rng = np.random.RandomState(S)
    B, H, K = 1, 2, 16
    r, k, v = (torch.from_numpy(rng.randn(B, S, H, K).astype(np.float32))
               for _ in range(3))
    logw = torch.from_numpy(-np.exp(0.5 * rng.randn(B, S, H, K)).astype(np.float32))
    u = torch.from_numpy(0.1 * rng.randn(H, K).astype(np.float32))
    s0 = torch.from_numpy(rng.randn(B, H, K, K).astype(np.float32))
    o, s = wkv_padded(ref.rwkv6_chunk_plain, r, k, v, logw, u, s0)
    want_o, want_s = ref.rwkv6_chunk_plain(r, k, v, logw, u, s0,
                                           out_dtype=torch.float32,
                                           chunk=_chunk_size(S))
    assert o.shape == want_o.shape
    assert _rel_err(o.numpy(), want_o.numpy()) < 1e-4
    assert _rel_err(s.numpy(), want_s.numpy()) < 1e-4
