"""One rank of the gloo world that tests/test_torch_layers.py spawns (8
ranks, one process each, on the CPU): the port's multi-device modules on
``DeviceMesh``es of ``("data", "model")`` (2, 4) and (4, 2) and
``("pod", "data", "model")`` (2, 2, 2), against the JAX package's values at
the same meshes (an npz that one JAX process with 8 host devices wrote) and
against the port's own single-device path.

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
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.distributed.fault_tolerance import load_checkpoint, save_checkpoint
from repro_torch.distributed.sharding import (
    ParallelConfig, dp_rank, local_tree, place, place_tree)
from repro_torch.models.moe import MoETransformer, moe_dispatch_local_ep, moe_route
from repro_torch.models.param_utils import shard_params, tree_flatten, tree_map
from repro_torch.models.registry import build_model
from repro_torch.models.seq_parallel import (
    SeqParallelDenseTransformer, reshard_cache_from_packed)
from repro_torch.models.transformer import DenseTransformer
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_update, init_opt_state, opt_state_specs, shard_opt_state)

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


def main(rank: int, workdir: str, npz: str) -> None:
    """Spawned entry of rank ``rank``: a gloo process group over a file
    store in ``workdir``, the checks, the readings to ``rank{rank}.json``."""
    try:
        torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        try:
            out = run(rank, workdir, npz)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
