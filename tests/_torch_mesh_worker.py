"""One rank of the gloo worlds that tests/test_torch_layers.py spawns (8
ranks, one process each, on the CPU): the port's multi-device modules on ``DeviceMesh``es of
``("data", "model")`` (2, 4) and (4, 2) and ``("pod", "data", "model")``
(2, 2, 2), against the JAX package's values at the same meshes (an npz that
one JAX process with 8 host devices wrote) and against the port's own
single-device path. ``main`` runs the PR-18 checks, ``main_tp`` the
whole-model tensor-parallel cells (prefill, decode, train).

This module imports torch, numpy and ``repro_torch`` only, never jax or
``repro`` (tests/test_torch_hygiene.py scans it), so the ranks run the port
alone. Each rank writes its readings to ``rank{r}.json`` under the work
directory, or its traceback to ``rank{r}.err``.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.distributed.fault_tolerance import load_checkpoint, save_checkpoint
from repro_torch.distributed.sharding import (
    ParallelConfig, dp_rank, local_tree, place, place_tree)
from repro_torch.launch.cells import TRAIN_GRAD_ACCUM, WHISPER_PROMPT_LEN
from repro_torch.models.moe import MoETransformer, moe_dispatch_local_ep, moe_route
from repro_torch.models.param_utils import shard_params, tree_flatten, tree_map
from repro_torch.models.registry import build_model
from repro_torch.models.seq_parallel import (
    SeqParallelDenseTransformer, reshard_cache_from_packed)
from repro_torch.models.transformer import DenseTransformer
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_update, init_opt_state, opt_state_specs, shard_opt_state)
from repro_torch.training.train_step import loss_and_grads

WORLD = 8
MESHES = {"24": ((2, 4), ("data", "model")),
          "222": ((2, 2, 2), ("pod", "data", "model")),
          "42": ((4, 2), ("data", "model"))}
SP_ARCHS = ("qwen3-1.7b", "gemma3-12b")
MOE_ARCH = "granite-moe-3b-a800m"


def sp_config(arch):
    """The sequence-parallel cases' config: float32, a vocab of 254 (padded
    to 256 at tp 4), qwen3 at 2 layers, gemma3 at its 6 (5 window : 1)."""
    cfg = get_smoke_config(arch).replace(vocab_size=254, dtype="float32")
    return cfg.replace(num_layers=2) if arch == "qwen3-1.7b" else cfg


def _nested(flat: dict) -> dict:
    out = {}
    for path, x in flat.items():
        *keys, last = path.split("/")
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[last] = x
    return out


def _tree(ref, prefix: str) -> dict:
    """The npz arrays under ``prefix/`` as a nested tree of tensors."""
    n = len(prefix) + 1
    return _nested({k[n:]: torch.from_numpy(ref[k]) for k in ref.files
                    if k.startswith(prefix + "/")})


def _coord(mesh) -> str:
    return "_".join(map(str, mesh.get_coordinate()))


def _rel(got, want, cols=None) -> float:
    """max |got - want| over the largest |want| (its first ``cols`` columns:
    the true vocab, where pad logits are -1e30)."""
    got, want = got.double(), want.double()
    scale = (want[..., :cols] if cols else want).abs().max()
    return float((got - want).abs().max() / scale)


@contextlib.contextmanager
def _counted(calls: dict):
    """Count the calls of the collectives named in ``calls`` while inside."""
    inner = {k: getattr(dist, k) for k in calls}

    def wrap(name):
        def fn(*a, **kw):
            calls[name] += 1
            return inner[name](*a, **kw)
        return fn
    for k in calls:
        setattr(dist, k, wrap(k))
    try:
        yield
    finally:
        for k, f in inner.items():
            setattr(dist, k, f)


def sp_decode(ref, mesh, arch) -> dict:
    """Two sequence-parallel decode steps from the JAX prefill's packed
    cache, the second reading the first's cache write."""
    cfg = sp_config(arch)
    pc = ParallelConfig.from_mesh(mesh)
    base = DenseTransformer(cfg, pc)
    sp = SeqParallelDenseTransformer(cfg, pc, mesh)
    key = f"sp/{arch}"
    params = shard_params(_tree(ref, f"{key}/params"), sp.templates(), pc, mesh)
    cache = reshard_cache_from_packed(_tree(ref, f"{key}/cache_b"), base, sp)
    pos = torch.from_numpy(ref[f"{key}/pos"])
    errs, calls = [], {"all_reduce": 0, "all_gather_into_tensor": 0}
    for i, (tok, at) in enumerate(((ref[f"{key}/tok1"], pos),
                                   (ref[f"{key}/tok2"], pos + 1))):
        with _counted(calls if i == 0 else {}):
            lg, cache = sp.decode_step(params, cache, torch.from_numpy(tok), at)
        errs.append(_rel(lg.full_tensor(), torch.from_numpy(ref[f"{key}/lg{i + 1}"]),
                         cfg.vocab_size))
    cache_err = max(_rel(cache[k].full_tensor(),
                         torch.from_numpy(ref[f"{key}/cache2/{k}"]))
                    for k in cache)
    pad = lg.full_tensor()[:, cfg.vocab_size:]
    return {"err1": errs[0], "err2": errs[1], "cache_err": cache_err,
            "pad_masked": bool((pad == -1e30).all()) and pad.shape[1] == 2,
            "local_seq": {k: v.to_local().shape[3] for k, v in cache.items()},
            "collectives": calls,
            "gspmd": {k.rsplit("/", 1)[1]: int(ref[k]) for k in ref.files
                      if k.startswith(f"{key}/gspmd/")}}


def local_ep(ref, mesh) -> dict:
    """``moe_dispatch_local_ep`` with capacity drops (capacity factor 1)."""
    pc = ParallelConfig.from_mesh(mesh)
    t = {k: torch.from_numpy(ref[f"ep/{k}"]) for k in ("x", "router", "wg", "wu", "wd")}
    x = place(t["x"], mesh, pc.spec("batch", None)).to_local()
    ws = [place(t[k], mesh, pc.spec("expert", None, None)).to_local()
          for k in ("wg", "wu", "wd")]
    top_k = int(ref["ep/top_k"])
    out, aux = moe_dispatch_local_ep(x, t["router"], *ws, top_k=top_k,
                                     capacity_factor=1.0, act="silu",
                                     mesh=mesh, pc=pc)
    rows = x.shape[0]
    r0 = dp_rank(mesh, pc) * rows
    want = torch.from_numpy(ref["ep/out"])[r0:r0 + rows]
    rt = moe_route(x, t["router"], ws[0].shape[0] * pc.tp, top_k=top_k,
                   capacity_factor=1.0)
    dropped = int((rt.dest == t["wg"].shape[0] * rt.capacity).sum())
    return {"err": _rel(out, want),
            "aux": float(aux), "aux_jax": float(ref[f"ep/aux/{_coord(mesh)}"]),
            "dropped": dropped}


def placement(ref, mesh, name) -> dict:
    """The JAX tree of each case placed by the port's specs: this rank's
    shard against the JAX device's shard at the same mesh coordinate."""
    pc = ParallelConfig.from_mesh(mesh)
    model = build_model(get_smoke_config(MOE_ARCH).replace(dtype="float32"), pc)
    pspecs = model.param_specs()
    specs = {"params": pspecs,
             "master": opt_state_specs(pspecs, model.abstract_params(), pc)["master"],
             "cache": model.cache_specs()}
    coord, n, bad = _coord(mesh), 0, []
    for tree, tspecs in specs.items():
        paths, leaf_specs = tree_flatten(tspecs)
        prefix = f"place/{name}/{tree}/"
        want_paths = sorted({k[len(prefix):].rsplit("/", 1)[0] for k in ref.files
                             if k.startswith(prefix)})
        if sorted(paths) != want_paths:
            bad.append(f"{tree}: paths {sorted(paths)} vs {want_paths}")
            continue
        for path, spec in zip(paths, leaf_specs):
            full = torch.from_numpy(ref[f"{prefix}{path}/full"])
            got = place(full, mesh, spec).to_local().numpy()
            want = ref[f"{prefix}{path}/{coord}"]
            n += 1
            if got.shape != want.shape or got.tobytes() != want.tobytes():
                bad.append(f"{tree}/{path} {spec}: {got.shape} vs {want.shape}")
    return {"leaves": n, "bad": bad}


def moe_model(mesh) -> dict:
    """granite's smoke MoETransformer with local expert parallelism (each
    rank its data shard of the batch, its experts) against the
    single-device model, capacity set so that nothing drops: prefill and
    one decode step."""
    cfg = get_smoke_config(MOE_ARCH).replace(dtype="float32")
    cfg = cfg.replace(moe_capacity_factor=float(cfg.num_experts))
    pc = ParallelConfig.from_mesh(mesh)
    single = MoETransformer(cfg, pc)
    ep = MoETransformer(cfg, pc)
    ep.mesh = mesh
    params = single.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    B, L = 4, 12
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32))
    lens = torch.tensor([12, 9, 5, 12], dtype=torch.int32)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32))
    lg_s, cache_s = single.prefill(params, toks, seq_lens=lens, max_len=16)
    dec_s, _ = single.decode_step(params, cache_s, nxt, lens)
    lp = local_tree(place_tree(params, mesh, ep.ep_param_specs()))
    b = B // pc.dp
    r = slice(dp_rank(mesh, pc) * b, (dp_rank(mesh, pc) + 1) * b)
    lg_m, cache_m = ep.prefill(lp, toks[r], seq_lens=lens[r], max_len=16)
    dec_m, _ = ep.decode_step(lp, cache_m, nxt[r], lens[r])
    return {"prefill_err": _rel(lg_m, lg_s[r], cfg.vocab_size),
            "decode_err": _rel(dec_m, dec_s[r], cfg.vocab_size),
            "local_experts": int(lp["blocks"]["w_gate"].shape[2]),
            "padded_experts": ep.padded_experts}


def _partial_over_data(g, mesh, spec):
    """``g`` as a DTensor ``Partial`` over the DP axes (the data-rank-0 ranks
    hold it, the others zeros, as a DP all-reduce's inputs), placed by
    ``spec`` on the model axis."""
    pc = ParallelConfig.from_mesh(mesh)
    local = place(g if dp_rank(mesh, pc) == 0 else torch.zeros_like(g),
                  mesh, spec)
    pl = [Partial() if name in pc.dp_axes else p
          for name, p in zip(mesh.mesh_dim_names, local.placements)]
    return DTensor.from_local(local.to_local(), mesh, pl, run_check=False,
                              shape=g.shape, stride=g.stride())


def zero1(ref, mesh) -> dict:
    """Two AdamW steps on ZeRO-1 state against the single-device steps."""
    cfg = get_smoke_config(MOE_ARCH).replace(dtype="float32")
    pc = ParallelConfig.from_mesh(mesh)
    model = build_model(cfg, pc)
    params = model.init_params(torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    grads = [tree_map(lambda p: torch.from_numpy(
        (2.0 * rng.randn(*p.shape)).astype(np.float32)), params) for _ in range(2)]
    acfg = AdamWConfig(lr=1e-2)
    pspecs = model.param_specs()
    sp_, so = params, init_opt_state(params)
    dp_ = shard_params(params, model.templates(), pc, mesh)
    do = shard_opt_state(init_opt_state(params), pspecs, params, pc, mesh)
    norms = []
    for g in grads:
        sp_, so, sm = adamw_update(sp_, g, so, acfg)
        dg = tree_map(lambda x, s: _partial_over_data(x, mesh, s), g, pspecs)
        dp_, do, dm = adamw_update(dp_, dg, do, acfg)
        norms.append((float(sm["grad_norm"]), float(dm["grad_norm"])))
    err = {}
    for name, got, want in (("params", dp_, sp_), ("m", do["m"], so["m"]),
                            ("v", do["v"], so["v"]),
                            ("master", do["master"], so["master"])):
        err[name] = max(_rel(a.full_tensor(), b) for a, b in
                        zip(tree_flatten(got)[1], tree_flatten(want)[1]))
    coord = _coord(mesh)
    paths, leaves = tree_flatten(do["m"])
    shapes_ok = all(list(x.to_local().shape) ==
                    list(ref[f"place/24/master/{p}/{coord}"].shape)
                    for p, x in zip(paths, leaves))
    dp_sharded = sum(any(isinstance(pl, Shard) and name == "data" for name, pl in
                         zip(mesh.mesh_dim_names, x.placements)) for x in leaves)
    params_placed = all(
        x.placements == y.placements for x, y in
        zip(tree_flatten(dp_)[1], tree_flatten(shard_params(
            params, model.templates(), pc, mesh))[1]))
    return {"err": err, "norms": norms, "shapes_ok": shapes_ok,
            "dp_sharded_leaves": dp_sharded, "params_placed": params_placed,
            "step": int(do["step"])}


def elastic(workdir, meshes) -> dict:
    """A checkpoint written by the port's fault_tolerance, restored onto
    (2, 4), then moved to (4, 2): the full tensors keep its bits."""
    cfg = get_smoke_config(MOE_ARCH)                       # bfloat16
    pc = ParallelConfig.from_mesh(meshes["24"])
    model = build_model(cfg, pc)
    params = model.init_params(torch.Generator().manual_seed(2))
    ckpt = os.path.join(workdir, "ckpt")
    opt = {"step": torch.tensor(7, dtype=torch.int32)}
    if dist.get_rank() == 0:
        save_checkpoint(ckpt, 7, {"params": params, "opt": opt})
    dist.barrier()
    skeleton = {"params": tree_map(lambda x: x.new_empty(0), params),
                "opt": tree_map(lambda x: x.new_empty(0), opt)}
    _, trees = load_checkpoint(ckpt, template_trees=skeleton)
    out = {}
    for name in ("24", "42"):
        model, trees = elastic_restore(build_model, cfg, meshes[name], trees)
        paths, got = tree_flatten(trees["params"])
        _, want = tree_flatten(params)
        out[name] = {
            "tp": model.pc.tp,
            "same_bits": all(g.full_tensor().dtype == w.dtype and torch.equal(
                g.full_tensor().view(torch.int16), w.view(torch.int16))
                for g, w in zip(got, want)),
            "sharded": sum(any(isinstance(p, Shard) for p in g.placements)
                           for g in got),
            "opt_passes": int(trees["opt"]["step"]) == 7,
        }
    return out


def run(rank: int, workdir: str, npz: str) -> dict:
    meshes = {k: init_device_mesh("cpu", shape, mesh_dim_names=names)
              for k, (shape, names) in MESHES.items()}
    ref = np.load(npz)
    out = {"coord24": meshes["24"].get_coordinate(),
           "sp": {a: sp_decode(ref, meshes["24"], a) for a in SP_ARCHS},
           "ep": local_ep(ref, meshes["24"]),
           "place": {k: placement(ref, meshes[k], k) for k in ("24", "222")},
           "moe_model": moe_model(meshes["24"]),
           "zero1": zero1(ref, meshes["24"]),
           "elastic": elastic(workdir, meshes)}
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


# the whole-model TP cells: arch -> config changes (float32 throughout);
# granite at capacity factor 1, so that slots drop
TP_CASES = {"qwen3-1.7b": {"vocab_size": 254},
            "gemma3-12b": {"vocab_size": 254},
            "granite-moe-3b-a800m": {"vocab_size": 254,
                                     "moe_capacity_factor": 1.0}}
# the second world ("families"): the other families' TP cells (hymba
# past its 8-token window; whisper's decoder long enough for the prefill
# cell's 64-token prompt), the fully sharded train cells of FSDP_ARCHS and
# one train cell with compressed gradients
FAMILY_CASES = {"rwkv6-7b": {"vocab_size": 254},
                "hymba-1.5b": {"vocab_size": 254},
                "whisper-base": {"vocab_size": 254, "max_target_len": 64}}
FSDP_ARCHS = ("qwen3-1.7b", "rwkv6-7b", "granite-moe-3b-a800m")
COMPRESS_ARCH, COMPRESS_MESH = "qwen3-1.7b", "24"
WORLDS = {"tp": TP_CASES, "families": FAMILY_CASES}
CONFIGS = {**TP_CASES, **FAMILY_CASES}
TP_S, TP_B = 16, 8      # every cell's sequence and batch (gemma3's window: 8)


def tp_config(arch):
    return get_smoke_config(arch).replace(dtype="float32", **CONFIGS[arch])


def cell_inputs(cfg) -> dict:
    """The cells' inputs from seed 0 (numpy; either package's config):
    tokens, prompt lengths (whisper: frame lengths), the decode step's
    tokens, labels with a fifth padded; whisper also 64-token prompts and
    labels and float32 frames."""
    rng = np.random.RandomState(0)
    S, B, V = TP_S, TP_B, cfg.vocab_size
    x = {"toks": rng.randint(0, V, (B, S)).astype(np.int32),
         "lens": rng.randint(S // 2, S, (B,)).astype(np.int32),
         "nxt": rng.randint(0, V, (B,)).astype(np.int32)}
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.2] = -1
    x["labels"] = labels
    if cfg.is_encoder_decoder:
        T = WHISPER_PROMPT_LEN      # the prefill cell's prompt, in both packages
        x["toks"] = rng.randint(0, V, (B, T)).astype(np.int32)
        labels = rng.randint(0, V, (B, T)).astype(np.int32)
        labels[rng.rand(B, T) < 0.2] = -1
        x["labels"] = labels
        x["frames"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    return x


def prefill_args(cfg, x) -> tuple:
    if cfg.is_encoder_decoder:
        return x["toks"], x["frames"], x["lens"]
    return x["toks"], x["lens"]


def train_batch(cfg, x) -> dict:
    out = {"tokens": x["toks"], "labels": x["labels"]}
    if cfg.is_encoder_decoder:
        out["frames"] = x["frames"]
    return out


def _cell(arch, shape, mesh, **kw):
    from repro_torch.configs import get_shape
    from repro_torch.launch.cells import build_cell

    base = get_shape(shape)
    return build_cell(arch, shape, mesh, cfg_override=tp_config(arch),
                      shape=ShapeConfig(base.name, base.kind, TP_S, TP_B), **kw)


def _grad_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))


def _tree_rel(got, want) -> dict:
    """``_grad_rel`` of each leaf of a DTensor tree against a tree of
    tensors, by path."""
    paths, leaves = tree_flatten(got)
    return {p: _grad_rel(g.full_tensor(), w) for p, g, w in
            zip(paths, leaves, tree_flatten(want)[1])}


def _adam_rel(new, want, grads) -> tuple:
    """``_tree_rel`` of one AdamW step's new parameters at the elements
    where the step is well conditioned, and the share of the others. The
    first step moves an element by lr·g/(|g| + eps), whose error for a
    gradient error d is lr·eps·d/(|g| + eps)²: within 1e-4 of lr for d at
    the gradients' own tolerance (1e-4 of the leaf's largest |g|) where
    g² >= eps·max|g|. Below that the step's size (and sign) comes from
    digits that the gradients' tolerance leaves open."""
    eps = AdamWConfig().eps
    rel, others, total = {}, 0, 0
    paths, leaves = tree_flatten(new)
    for p, x, w, g in zip(paths, leaves, tree_flatten(want)[1],
                          tree_flatten(grads)[1]):
        g = g.double().abs()
        well = g * g >= eps * g.max()
        others, total = others + int((~well).sum()), total + well.numel()
        d = (x.full_tensor().double() - w.double()).abs() * well
        rel[p] = float(d.max() / w.double().abs().max().clamp(min=1e-12))
    return rel, others / total


def _miss_share(got, want) -> dict:
    """Per leaf of a DTensor tree, the share of its elements that differ
    from the reference's by more than 1e-4 of the leaf's largest."""
    out = {}
    paths, leaves = tree_flatten(got)
    for p, x, w in zip(paths, leaves, tree_flatten(want)[1]):
        w = w.double()
        miss = (x.full_tensor().double() - w).abs() > 1e-4 * w.abs().max()
        out[p] = float(miss.double().mean())
    return out


def _counted_tp(fn):
    TP.reset_collective_counts()
    out = fn()
    return out, TP.collective_counts()


def _device_mean(ref, prefix) -> float:
    """The mean of a scalar's values on the reference's devices."""
    vals = [float(ref[k]) for k in ref.files if k.startswith(prefix + "/")]
    return float(np.mean(vals))


def _inputs(ref, key, cfg) -> dict:
    return {k: torch.from_numpy(ref[f"{key}/{k}"]) for k in cell_inputs(cfg)}


def _placed(cell, full, mesh):
    """The cell's parameters and optimizer state placed by its in_shardings
    (the fully sharded layout's specs, or param_specs and ZeRO-1)."""
    specs = cell.in_shardings[0]
    return (place_tree(full, mesh, specs),
            shard_opt_state(init_opt_state(full), specs, full, cell.pc, mesh))


def tp_cells(ref, mesh, name, cases) -> dict:
    """The port's prefill, decode and train cells of each case on the JAX
    weights and inputs, against the JAX cells' outputs at the same mesh."""
    out = {}
    coord = _coord(mesh)
    for arch in cases:
        cfg, key = tp_config(arch), f"{name}/{arch}"
        V = cfg.vocab_size
        x = _inputs(ref, key, cfg)
        pre = _cell(arch, "prefill_32k", mesh)
        full = _tree(ref, f"{key}/params")
        params = shard_params(full, pre.model.templates(), pre.pc, mesh)
        (lg, cache), c_pre = _counted_tp(
            lambda: pre.fn(params, *prefill_args(cfg, x)))
        # the prefill's attention caches at each row's valid positions
        # (rows past a prompt's length are never read; the two packages'
        # prefills mask them differently: the reference by seq_lens, the
        # port's flash_prefill path causally only)
        valid = torch.arange(TP_S)[None, :] < x["lens"][:, None]     # [B, S]
        cache_err = 0.0
        for k, v in _tree(ref, f"{key}/cache").items():
            got = cache[k].full_tensor()
            if k.endswith("_full"):
                m = valid[None, None, :, :, None, None]
                got, v = got * m, v * m
            cache_err = max(cache_err, _rel(got, v))
        dec = _cell(arch, "decode_32k", mesh)
        jcache = place_tree(_tree(ref, f"{key}/cache"), mesh, dec.model.cache_specs())
        (dlg, _), c_dec = _counted_tp(lambda: dec.fn(params, jcache, x["nxt"],
                                                      x["lens"]))
        hidden_err = None
        if cfg.family == "dense":     # MoE capacity is per data shard
            # forward_hidden on the rank's rows against the model on one
            # device with the whole weights
            one = build_model(cfg, pre.pc)
            with torch.no_grad():
                emb = one.embed_tokens(full, x["toks"])
                pos = torch.arange(TP_S, dtype=torch.int32).expand(TP_B, TP_S)
                want, _, _ = one.forward_hidden(full, emb, pos, x["lens"])
                got, _, _ = pre.model.forward_hidden(params, emb, pos, x["lens"])
            b = TP_B // pre.pc.dp
            r0 = dp_rank(mesh, pre.pc) * b
            hidden_err = _rel(got, want[r0:r0 + b])
        tr = _cell(arch, "train_4k", mesh)
        opt = shard_opt_state(init_opt_state(full), tr.model.param_specs(), full,
                              tr.pc, mesh)
        batch = train_batch(cfg, x)
        _, _, metrics = tr.fn(params, opt, batch)
        (loss, grads), c_grad = _counted_tp(
            lambda: loss_and_grads(tr.model, params, batch, False))
        with torch.no_grad():
            _, c_fwd = _counted_tp(lambda: tr.model.train_loss(params, batch,
                                                               remat=False))
        _, remat_grads = loss_and_grads(tr.model, params, batch, True)
        got = tree_flatten(grads)[1]
        remat_same = all(torch.equal(a.full_tensor(), b.full_tensor()) for a, b in
                         zip(got, tree_flatten(remat_grads)[1]))
        out[arch] = {
            "prefill_err": _rel(lg.full_tensor(), torch.from_numpy(ref[f"{key}/lg"]), V),
            "decode_err": _rel(dlg.full_tensor(), torch.from_numpy(ref[f"{key}/dlg"]), V),
            "cache_err": cache_err, "hidden_err": hidden_err,
            "loss": float(loss), "loss_jax": _device_mean(ref, f"{key}/loss"),
            "loss_jax_own": float(ref[f"{key}/loss/{coord}"]),
            "step_loss": float(metrics["loss"]),
            "step_loss_jax": _device_mean(ref, f"{key}/step_loss"),
            "grad_norm": float(metrics["grad_norm"]),
            "grad_norm_jax": float(ref[f"{key}/grad_norm"]),
            "grad_err": _tree_rel(grads, _tree(ref, f"{key}/grads")),
            "remat_same": remat_same,
            "calls": {"prefill": c_pre, "decode": c_dec, "grads": c_grad,
                      "forward": c_fwd},
            "layers": cfg.num_layers, "enc_layers": cfg.num_encoder_layers,
            "family": cfg.family, "qk_norm": cfg.qk_norm,
            "chunks": 4 if cfg.is_encoder_decoder else 8,
            "dp_axes": len(tr.pc.dp_axes),
            "local": {k: (list(v.to_local().shape), list(v.shape))
                      for k, v in cache.items()},
        }
    return out


def fsdp_cell(ref, mesh, name, arch) -> dict:
    """The fully sharded train cell (``train_layout="fsdp"``): one step's
    loss, gradient norm, new parameters and moments, and one loss's
    gradients, against the reference's fsdp cell on the same mesh; the
    collectives of a forward, of its gradients and of its gradients under
    remat."""
    cfg, key = tp_config(arch), f"{name}/fsdp/{arch}"
    x = _inputs(ref, key, cfg)
    tr = _cell(arch, "train_4k", mesh, train_layout="fsdp")
    full = _tree(ref, f"{key}/params")
    params, opt = _placed(tr, full, mesh)
    batch = train_batch(cfg, x)
    new, new_opt, metrics = tr.fn(params, opt, batch)
    (loss, grads), c_grad = _counted_tp(
        lambda: loss_and_grads(tr.model, params, batch, False))
    with torch.no_grad():
        _, c_fwd = _counted_tp(lambda: tr.model.train_loss(params, batch,
                                                           remat=False))
    _, c_remat = _counted_tp(lambda: loss_and_grads(tr.model, params, batch, True))
    leaves = tree_flatten(params)[1]
    params_err, ill = _adam_rel(new, _tree(ref, f"{key}/new"),
                                _tree(ref, f"{key}/grads"))
    blocks = [k for k in params if isinstance(params[k], dict)]
    by_layer = sum(any(isinstance(p, Shard) and p.dim > 0 for p in x.placements)
                   for b in blocks for x in params[b].values())
    return {"loss": float(loss), "loss_jax": _device_mean(ref, f"{key}/loss"),
            "step_loss": float(metrics["loss"]),
            "step_loss_jax": _device_mean(ref, f"{key}/step_loss"),
            "grad_norm": float(metrics["grad_norm"]),
            "grad_norm_jax": float(ref[f"{key}/grad_norm"]),
            "grad_err": _tree_rel(grads, _tree(ref, f"{key}/grads")),
            "params_err": params_err, "ill_share": ill,
            "m_err": _tree_rel(new_opt["m"], _tree(ref, f"{key}/m")),
            "v_err": _tree_rel(new_opt["v"], _tree(ref, f"{key}/v")),
            "calls": {"forward": c_fwd, "grads": c_grad, "remat": c_remat},
            "dp_axes": len(tr.pc.dp_axes), "tp": tr.pc.tp,
            "groups": tr.model.n_groups, "by_layer": by_layer,
            "moe_layers": cfg.num_layers if cfg.family == "moe" else 0,
            "sharded": sum(any(isinstance(p, Shard) for p in x.placements)
                           for x in leaves),
            "leaves": len(leaves)}


def compress_cell(ref, mesh, name) -> dict:
    """The train cell with compressed gradients (tensor-parallel layout,
    grad_accum as TRAIN_GRAD_ACCUM): new parameters, m, v and err against
    the reference's cell."""
    arch, key = COMPRESS_ARCH, f"{name}/compress"
    cfg = tp_config(arch)
    x = _inputs(ref, key, cfg)
    tr = _cell(arch, "train_4k", mesh, compress_grads=True)
    params, opt = _placed(tr, _tree(ref, f"{key}/params"), mesh)
    new, new_opt, metrics = tr.fn(params, opt, train_batch(cfg, x))
    err = new_opt["err"]
    return {"params_err": _tree_rel(new, _tree(ref, f"{key}/new")),
            "m_miss": _miss_share(new_opt["m"], _tree(ref, f"{key}/m")),
            "v_miss": _miss_share(new_opt["v"], _tree(ref, f"{key}/v")),
            "err_max": max(float(e.full_tensor().abs().max())
                           for e in tree_flatten(err)[1]),
            "err_max_jax": max(float(np.abs(ref[k]).max()) for k in ref.files
                               if k.startswith(f"{key}/err/")),
            "err_placed": all(e.placements == m.placements for e, m in zip(
                tree_flatten(err)[1], tree_flatten(new_opt["m"])[1])),
            "step_loss": float(metrics["loss"]),
            "step_loss_jax": _device_mean(ref, f"{key}/step_loss"),
            "grad_accum": TRAIN_GRAD_ACCUM[arch]}


def run_tp(rank: int, workdir: str, npz: str) -> dict:
    ref = np.load(npz)
    world = str(ref["world"])
    out = {}
    for name in map(str, ref["meshes"]):
        shape, names = MESHES[name]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out[name] = tp_cells(ref, mesh, name, WORLDS[world])
        if world == "families":
            out[name]["fsdp"] = {a: fsdp_cell(ref, mesh, name, a)
                                 for a in FSDP_ARCHS}
            if name == COMPRESS_MESH:
                out[name]["compress"] = compress_cell(ref, mesh, name)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def main_tp(rank: int, workdir: str, npz: str) -> None:
    main(rank, workdir, npz, run_tp)


def main(rank: int, workdir: str, npz: str, checks=None) -> None:
    """Spawned entry of rank ``rank``: a gloo process group over a file
    store in ``workdir``, the checks (``run`` by default), the readings to
    ``rank{rank}.json``."""
    checks = checks or run
    try:
        torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        try:
            out = checks(rank, workdir, npz)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(workdir, npz, entry, deadline_s: float) -> list:
    """``WORLD`` spawned ranks running ``entry(rank, workdir, npz)``; every
    rank must exit 0 before ``deadline_s`` (else all are killed and the
    caller's assertion carries the first rank's traceback). Returns each
    rank's readings."""
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=entry, args=(r, str(workdir), str(npz)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = [os.path.join(workdir, f"rank{r}.err") for r in range(WORLD)]
    errs = [open(e).read() for e in errs if os.path.exists(e)]
    assert not late, f"ranks {late} passed the {deadline_s} s deadline; {errs[:1]}"
    assert all(p.exitcode == 0 for p in procs), errs[:1] or [p.exitcode for p in procs]
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


# The reference's cells (``repro.launch.cells.build_cell``, shrunk as in
# tests/test_dryrun_small.py, jitted on meshes of 8 host devices) for
# ``main_tp``, written by a JAX process: ``python -c TP_JAX_SCRIPT <npz>
# <this module's path> <world> <mesh name>...``. A string here: this module
# itself imports no jax.
TP_JAX_SCRIPT = r"""import os
# LLVM's cheaper passes: the same programs compile in ~0.6 of the time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import sys
sys.path.insert(0, os.path.dirname(sys.argv[2]))
import numpy as np
import jax
import repro.configs as C
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.cells import build_cell
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.training.optimizer import init_opt_state
import _torch_mesh_worker as W

out = {}


def cell_of(arch, shape, mesh, cfg, **kw):
    base = C.SHAPES_BY_NAME[shape]
    C.SHAPES_BY_NAME[shape] = ShapeConfig(base.name, base.kind, W.TP_S, W.TP_B)
    try:
        return build_cell(arch, shape, mesh, cfg_override=cfg, **kw)
    finally:
        C.SHAPES_BY_NAME[shape] = base


def flat(tree, prefix):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield prefix + "/" + "/".join(str(k.key) for k in path), np.asarray(x)


def per_device(x, key, cm):
    for sh in x.addressable_shards:
        out[f"{key}/{cm[sh.device.id]}"] = np.asarray(sh.data)


def inputs(key, cfg):
    x = W.cell_inputs(cfg)
    out.update({f"{key}/{k}": v for k, v in x.items()})
    return x, W.train_batch(cfg, x)


def grads_of(tr, params, batch):
    loss_fn = lambda p, b: tr.model.train_loss(p, b)[0]
    sh = (tr.in_shardings[0], tr.in_shardings[2])
    return jax.jit(jax.value_and_grad(loss_fn), in_shardings=sh)(params, batch)


def step(key, tr, params, batch, cm):
    new, opt, metrics = jax.jit(tr.fn, in_shardings=tr.in_shardings)(
        params, jax.tree.map(np.asarray, init_opt_state(params)), batch)
    per_device(metrics["loss"], key + "/step_loss", cm)
    out[key + "/grad_norm"] = np.asarray(metrics["grad_norm"])
    return new, opt


world, meshes = sys.argv[3], sys.argv[4:]
for name in meshes:
    dims, names = W.MESHES[name]
    mesh = compat_make_mesh(dims, names)
    compat_set_mesh(mesh)
    cm = {d.id: "_".join(map(str, i)) for i, d in np.ndenumerate(mesh.devices)}
    for arch, kw in W.WORLDS[world].items():
        cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
        key = f"{name}/{arch}"
        pre = cell_of(arch, "prefill_32k", mesh, cfg)
        # numpy arguments: each jit places them by its own in_shardings
        params = jax.tree.map(np.asarray, pre.model.init_params(jax.random.PRNGKey(0)))
        if world == "families":
            # no leaf left at its constant init (zero biases and decays, unit
            # scales), where a rank taking the wrong columns of a replicated
            # leaf, or adding a replicated bias once per rank, would not show
            noise = np.random.RandomState(1)
            params = jax.tree.map(lambda a: (a + 0.05 * noise.standard_normal(
                a.shape)).astype(a.dtype), params)
        x, batch = inputs(key, cfg)
        with mesh:
            lg, cache = jax.jit(pre.fn, in_shardings=pre.in_shardings)(
                params, *W.prefill_args(cfg, x))
            dec = cell_of(arch, "decode_32k", mesh, cfg)
            dlg, _ = jax.jit(dec.fn, in_shardings=dec.in_shardings)(
                params, jax.tree.map(np.asarray, cache), x["nxt"], x["lens"])
            tr = cell_of(arch, "train_4k", mesh, cfg)
            step(key, tr, params, batch, cm)
            loss, grads = grads_of(tr, params, batch)
        out.update(flat(params, key + "/params"))
        out.update(flat(cache, key + "/cache"))
        out.update(flat(grads, key + "/grads"))
        out.update({key + "/lg": np.asarray(lg), key + "/dlg": np.asarray(dlg)})
        per_device(loss, key + "/loss", cm)
    if world != "families":
        continue
    # the fully sharded train cells, and compressed gradients
    cells = [(f"{name}/fsdp/{a}", a, dict(train_layout="fsdp")) for a in W.FSDP_ARCHS]
    if name == W.COMPRESS_MESH:
        cells.append((f"{name}/compress", W.COMPRESS_ARCH, dict(compress_grads=True)))
    for key, arch, kw in cells:
        cfg = get_smoke_config(arch).replace(dtype="float32", **W.CONFIGS[arch])
        tr = cell_of(arch, "train_4k", mesh, cfg, **kw)
        params = jax.tree.map(np.asarray, tr.model.init_params(jax.random.PRNGKey(0)))
        x, batch = inputs(key, cfg)
        with mesh:
            new, opt = step(key, tr, params, batch, cm)
            loss, grads = grads_of(tr, params, batch)
        out.update(flat(params, key + "/params"))
        out.update(flat(new, key + "/new"))
        out.update(flat(grads, key + "/grads"))
        for k in ("m", "v", "err"):
            if opt.get(k) is not None:
                out.update(flat(opt[k], f"{key}/{k}"))
        per_device(loss, key + "/loss", cm)

out["meshes"] = np.asarray(meshes)
out["world"] = np.asarray(world)
np.savez(sys.argv[1], **out)
print("WROTE", len(out))
"""


def tp_world(workdir, meshes, deadline_s: float, world: str = "tp") -> list:
    """The reference's cells of ``world`` (a key of ``WORLDS``) at
    ``meshes`` (names of ``MESHES``), one JAX process per mesh side by side,
    then the port's cells on them in a spawned world."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(str(workdir), "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(here), "src"),
               JAX_PLATFORMS="cpu")
    procs = {m: subprocess.Popen([sys.executable, "-c", TP_JAX_SCRIPT,
                                  f"{npz}.{m}.npz", os.path.abspath(__file__),
                                  world, m], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in meshes}
    try:
        for p in procs.values():
            _, err = p.communicate(timeout=420)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = {}
    for m in meshes:
        with np.load(f"{npz}.{m}.npz") as z:
            ref.update({k: z[k] for k in z.files})
    ref["meshes"] = np.asarray(meshes)
    np.savez(npz, **ref)
    return spawn(workdir, npz, main_tp, deadline_s)


def check_tp_cells(ranks, arch, mesh):
    """The port's prefill and decode cells, run tensor-parallel on DTensor
    weights placed by param_specs, give the reference cells' logits to 1e-5
    of the largest (16-token prompts: gemma3's past its 8-token window;
    granite at capacity factor 1, where slots drop), the prefill's caches
    too, and a dense model's ``forward_hidden`` on the rank's rows equals
    the model on one device with the whole weights; the train cell's loss
    (grad_accum as TRAIN_GRAD_ACCUM) and one loss's gradients (to 1e-4 of
    each leaf's largest) and their norm equal the reference's.

    The MoE loss: the reference's local-EP aux is each data shard's own
    value, so its devices' losses differ by data shard, while its gradient
    is that of the shards' mean aux (its shard_map transposes the
    replicated aux's cotangent divided by the device count). The port's
    loss is that mean, on every rank: it equals the mean of the
    reference's device values, and the gradients equal the reference's
    (ROADMAP.md §3)."""
    for r in ranks:
        got = r[mesh][arch]
        assert got["prefill_err"] < 1e-5 and got["decode_err"] < 1e-5, got
        assert got["cache_err"] < 1e-5, got
        if not arch.startswith("granite"):
            assert got["hidden_err"] < 1e-5, got
        for a, b in (("loss", "loss_jax"), ("step_loss", "step_loss_jax"),
                     ("grad_norm", "grad_norm_jax")):
            assert abs(got[a] - got[b]) <= 1e-5 * abs(got[b]), (a, got)
        assert max(got["grad_err"].values()) < 1e-4, got["grad_err"]
        assert got["remat_same"]
    own = {r[mesh][arch]["loss_jax_own"] for r in ranks}
    if arch.startswith("granite"):
        assert len(own) > 1, own           # by data shard in the reference
    else:
        assert len(own) == 1, own


def check_tp_calls(ranks, arch, mesh):
    """The port's collective calls per step, on every rank: a prefill or a
    decode step issues one all-reduce per layer for the attention and one
    for the MLP (the MoE dispatch: its output and its aux loss), one for the
    embedding and one all-gather of the logits. A loss's forward adds three
    per cross-entropy chunk (max, sum of exps, label logit) and two per DP
    axis (total and count; MoE: and the aux loss); its backward issues one
    all-reduce per ``enter`` (QKV input, q/k norms, MLP or MoE input and router, the
    hidden state before the logits) and none per ``reduce``: an all-reduce
    in the backward of ``reduce`` would multiply the gradients by tp."""
    for r in ranks:
        got = r[mesh][arch]
        L, moe = got["layers"], arch.startswith("granite")
        per_layer = 3 if moe else 2
        step = {"all_reduce": per_layer * L + 1, "all_gather_into_tensor": 1}
        assert got["calls"]["prefill"] == step, got["calls"]
        assert got["calls"]["decode"] == step, got["calls"]
        # (MoE: one more per DP axis, the aux loss's mean over them)
        fwd = (per_layer * L + 1 + 3 * got["chunks"]
               + (3 if moe else 2) * got["dp_axes"])
        assert got["calls"]["forward"] == {"all_reduce": fwd}, got["calls"]
        enters = L * (1 + 2 * got["qk_norm"] + (2 if moe else 1)) + 1
        assert got["calls"]["grads"] == {"all_reduce": fwd + enters}, got["calls"]


def check_family_cells(ranks, arch, mesh):
    """rwkv6, hymba and whisper run tensor-parallel on DTensor weights
    placed by param_specs: their prefill and decode cells give the reference
    cells' logits and the prefill's caches to 1e-5 of the largest (hymba's
    rings past its 8-token window; whisper over ragged frames), the train
    cell's loss and gradient norm to 1e-5 and one loss's gradients to 1e-4
    of each leaf's largest, with and without remat alike. Each cache comes
    back on the rank's rows and, where ``cache_specs`` shards it, on its
    heads: rwkv6's WKV state, hymba's conv and SSM state on ``d_inner``,
    whisper's K/V on its kv slots."""
    tp, dp = (4, 2) if mesh == "24" else (2, 4)
    for r in ranks:
        got = r[mesh][arch]
        assert got["prefill_err"] < 1e-5 and got["decode_err"] < 1e-5, got
        assert got["cache_err"] < 1e-5, got
        for a, b in (("loss", "loss_jax"), ("step_loss", "step_loss_jax"),
                     ("grad_norm", "grad_norm_jax")):
            assert abs(got[a] - got[b]) <= 1e-5 * abs(got[b]), (a, got)
        assert max(got["grad_err"].values()) < 1e-4, got["grad_err"]
        assert got["remat_same"]
        for k, (local, full) in got["local"].items():
            by_heads = k not in ("tm_shift", "cm_shift", "frame_lens")
            assert np.prod(full) == np.prod(local) * dp * (tp if by_heads else 1), (k, local, full)
    assert len({r[mesh][arch]["loss_jax_own"] for r in ranks}) == 1


def check_family_calls(ranks, arch, mesh):
    """The collective calls per step on every rank (L decoder layers, Le
    encoder layers; S = 16 is one chunk of hymba's scan):

    - rwkv6: a prefill or decode step all-reduces the time mix's ``w_o`` and
      the channel mix's ``wc_v`` products and all-gathers its gate columns
      per layer, plus the embedding's all-reduce and the logits' gather;
    - hymba: the attention's and the MLP's all-reduce, the Mamba branch's
      ``m_wx`` and ``m_out`` all-reduces and ``m_in``'s all-gather per layer;
    - whisper: one all-reduce per attention and per MLP (encoder 2 per
      layer, decoder 3), the embedding's and the logits' gather.

    A loss's forward adds three per cross-entropy chunk and two per DP axis
    and leaves out the logits' gather. Its backward issues one all-reduce
    per ``enter``: rwkv6 13 per layer (the time mix's input and its nine
    replicated weights, the channel mix's input and two), hymba 4 (the
    attention's, MLP's and ``m_in``'s input, ``m_wx``'s reduced product),
    whisper 2 per encoder layer and 4 per decoder layer (cross attention's
    query and encoder states), plus the hidden state before the loss; and
    hymba's ``m_in`` gather a reduce-scatter per layer."""
    for r in ranks:
        got = r[mesh][arch]
        L, Le, fam = got["layers"], got["enc_layers"], got["family"]
        per_chunk = 3 * got["chunks"] + 2 * got["dp_axes"]
        if fam == "ssm":
            pre = dec = {"all_reduce": 2 * L + 1, "all_gather_into_tensor": L + 1}
            enters, gathers, scatters = 13 * L + 1, L, 0
        elif fam == "hybrid":
            pre = dec = {"all_reduce": 4 * L + 1, "all_gather_into_tensor": L + 1}
            enters, gathers, scatters = 4 * L + 1, L, L
        else:
            pre = {"all_reduce": 2 * Le + 3 * L + 1, "all_gather_into_tensor": 1}
            dec = {"all_reduce": 3 * L + 1, "all_gather_into_tensor": 1}
            enters, gathers, scatters = 2 * Le + 4 * L + 1, 0, 0
        assert got["calls"]["prefill"] == pre, got["calls"]
        assert got["calls"]["decode"] == dec, got["calls"]
        fwd = {"all_reduce": pre["all_reduce"] + per_chunk}
        if gathers:
            fwd["all_gather_into_tensor"] = gathers
        assert got["calls"]["forward"] == fwd, got["calls"]
        grads = dict(fwd, all_reduce=fwd["all_reduce"] + enters)
        if scatters:
            grads["reduce_scatter_tensor"] = scatters
        assert got["calls"]["grads"] == grads, got["calls"]


def check_fsdp(ranks, arch, mesh):
    """The fully sharded train cell (every mesh axis on the batch, no model
    axis; every leaf sharded by ``zero1_spec`` over all axes; granite at
    capacity factor 1, slots dropping from the whole batch's route): its
    loss and gradient norm to 1e-5 of the reference's, one loss's gradients
    and the step's moments to 1e-4 of each leaf's largest, and its new
    parameters to 1e-4 wherever Adam's first step is well conditioned
    (``_adam_rel``: at least 80% of the elements)."""
    for r in ranks:
        got = r[mesh]["fsdp"][arch]
        for a, b in (("loss", "loss_jax"), ("step_loss", "step_loss_jax"),
                     ("grad_norm", "grad_norm_jax")):
            assert abs(got[a] - got[b]) <= 1e-5 * abs(got[b]), (a, got)
        for k in ("grad_err", "m_err", "v_err", "params_err"):
            assert max(got[k].values()) < 1e-4, (k, got[k])
        assert got["ill_share"] <= 0.2, got["ill_share"]
        assert got["tp"] == 1 and got["dp_axes"] == len(mesh)
        assert got["sharded"] == got["leaves"], got


def check_fsdp_calls(ranks, arch, mesh):
    """The fully sharded layout's collectives: each sharded leaf is
    all-gathered over every mesh axis (innermost first), a stacked leaf once
    per layer group inside the group's step, the others once; an MoE layer
    gathers every rank's tokens too (the reference routes the whole batch)
    and its loss takes the aux loss's mean; a forward adds the loss's two
    all-reduces per axis; the backward reduce-scatters each gather; remat
    gathers each group's leaves and tokens again."""
    for r in ranks:
        got = r[mesh]["fsdp"][arch]
        n, G, by_layer = got["dp_axes"], got["groups"], got["by_layer"]
        moe = got["moe_layers"]
        gathers = n * (by_layer * G + got["sharded"] - by_layer + moe)
        fwd = {"all_gather_into_tensor": gathers,
               "all_reduce": (3 if moe else 2) * n}
        assert got["calls"]["forward"] == fwd, got["calls"]
        assert got["calls"]["grads"] == dict(fwd, reduce_scatter_tensor=gathers)
        assert got["calls"]["remat"] == dict(
            fwd, reduce_scatter_tensor=gathers,
            all_gather_into_tensor=gathers + n * (by_layer * G + moe)), got["calls"]


def check_compress(ranks):
    """qwen3's train cell with compressed gradients at (2, 4), grad_accum 2:
    each microbatch's gradient reduce-scattered to its ZeRO-1 shard, then
    rounded to bf16. The new parameters equal the reference's to 1e-4 of
    each leaf's largest, and so do m and v at all but at most 1e-3 of each
    leaf's elements: there the two packages' f32 sums (in other orders) fall
    on either side of a bf16 rounding boundary. Rounding each rank's part
    before the sum moves most elements. ``err`` lies on m's shards and is
    zero in both packages: the gradients are bf16 already when the error
    term is added, so the reference's feedback carries nothing."""
    for r in ranks:
        got = r[COMPRESS_MESH]["compress"]
        assert max(got["params_err"].values()) < 1e-4, got["params_err"]
        for k in ("m_miss", "v_miss"):
            assert max(got[k].values()) <= 1e-3, (k, got[k])
        assert got["err_max"] == got["err_max_jax"] == 0.0 and got["err_placed"]
        assert abs(got["step_loss"] - got["step_loss_jax"]) <= 1e-5 * got["step_loss_jax"]
        assert got["grad_accum"] == 2
