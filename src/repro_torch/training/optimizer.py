"""AdamW with float32 master weights and ZeRO-1 optimizer-state sharding,
the PyTorch counterpart of ``repro/training/optimizer.py``.

Optimizer state (m, v, master) is sharded over the data-parallel axes on the
first free (unsharded, divisible) dimension of each tensor, on top of the
parameter's tensor-parallel sharding (``opt_state_specs``; placed as
DTensors by ``shard_opt_state``). ``adamw_update`` then runs the ZeRO-1
schedule explicitly: each gradient is redistributed to its state's placement
(from ``Partial``, a reduce-scatter; from ``Replicate``, a slice), each rank
updates its shard in place, and the new parameters are gathered back to
their own placement (an all-gather over the data-parallel axes).

The update is the reference's own formula, not ``torch.optim.AdamW``'s:
gradients clipped by their global norm, then
``master -= lr * (mhat / (sqrt(vhat) + eps) + weight_decay * master)``, then
every parameter cast to the first leaf's dtype (leaves in ``jax.tree_util``
order). Trees are nested dicts of tensors (``param_utils.tree_*``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    ParallelConfig, PartitionSpec, place_tree)
from repro_torch.models.param_utils import tree_flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params):
    """m, v and master in float32 (master a copy, never the params' own
    storage), step an int32 scalar, err None until gradient compression
    fills it."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_flatten(params)[1][0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "err": None,
    }


def abstract_opt_state(abstract_params):
    """Shapes and dtypes of ``init_opt_state``'s tree (``meta`` tensors)."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
    return {
        "m": tree_map(f32, abstract_params),
        "v": tree_map(f32, abstract_params),
        "master": tree_map(f32, abstract_params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "err": None,
    }


def zero1_spec(spec: PartitionSpec, shape: Tuple[int, ...],
               pc: ParallelConfig) -> PartitionSpec:
    """Add DP sharding on the first free divisible dim of a param spec."""
    if not pc.dp_axes or pc.dp <= 1:
        return spec
    used = set()
    for e in spec:
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            used.add(a)
    if any(a in used for a in pc.dp_axes):
        return spec   # already DP-sharded (e.g. FSDP params)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, dim) in enumerate(zip(entries, shape)):
        if s is None and dim % pc.dp == 0 and dim >= pc.dp:
            entries[i] = pc.dp_axes if len(pc.dp_axes) > 1 else pc.dp_axes[0]
            return PartitionSpec(*entries)
    return spec  # nothing shardable: stay param-sharded (small tensor)


def opt_state_specs(param_specs, abstract_params, pc: ParallelConfig):
    zp = tree_map(lambda sp, t: zero1_spec(sp, t.shape, pc), param_specs,
                  abstract_params)
    return {"m": zp, "v": zp, "master": zp, "step": PartitionSpec(), "err": None}


def shard_opt_state(state, param_specs, params, pc: ParallelConfig, mesh):
    """``state`` with m, v and master placed on ``mesh`` by their ZeRO-1
    specs (``params`` gives the shapes); step and err pass through."""
    specs = opt_state_specs(param_specs, params, pc)
    return dict(state, **{k: place_tree(state[k], mesh, specs[k])
                          for k in ("m", "v", "master")})


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """The gradients' global L2 norm, a plain tensor on every rank (each
    DTensor leaf's sum of squares reduced across the ranks)."""
    return torch.sqrt(sum(_full(torch.sum(torch.square(g.float())))
                          for g in tree_flatten(tree)[1]))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *,
                 in_place: bool = False):
    """One AdamW step on the float32 masters -> (params in the first leaf's
    dtype, state, metrics). ``state``'s m, v and master are updated in place
    (the reference's jit wrapper donates them); each is computed as the
    reference's expression, operation for operation. On DTensor state each
    rank updates its own shards; the parameters come back in the placements
    of ``params``.

    With ``in_place`` everything the reference donates is written where it
    is, for a captured step (``train_step.TrainStep``): the step counter
    through ``add_``, each parameter through ``copy_`` from its master (the
    cast's rounding and bits), and the returned trees are ``params`` and
    ``state`` themselves."""
    step = state["step"].add_(1) if in_place else state["step"] + 1
    # each gradient to its state's shard first (ZeRO-1: from Partial, a
    # reduce-scatter), so the norm sums shards, not whole gradients
    grads = tree_map(lambda g, m: g.redistribute(m.device_mesh, m.placements)
                     if isinstance(m, DTensor) else g, grads, state["m"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    c1, c2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf

    def upd(g, m, v, master):
        if isinstance(m, DTensor):      # to the state's shard: ZeRO-1
            g = g.redistribute(m.device_mesh, m.placements).to_local()
        m, v, master = _local(m), _local(v), _local(master)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        # master -= lr * (mhat / (sqrt(vhat) + eps) + weight_decay * master),
        # operation for operation, its temporaries reused in place
        upd = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        master.sub_(upd.add_(cfg.weight_decay * master).mul_(cfg.lr))

    tree_map(upd, grads, state["m"], state["v"], state["master"])
    dtype = tree_flatten(params)[1][0].dtype

    def cast(w, p):
        w = w.to(dtype, copy=True)
        if isinstance(w, DTensor):      # gathered to the param's placement
            w = w.redistribute(p.device_mesh, p.placements)
        return w

    def write(w, p):
        return p.copy_(cast(w, p) if isinstance(w, DTensor) else w)

    if in_place:
        tree_map(write, state["master"], params)
        return params, state, {"grad_norm": gnorm}
    new_params = tree_map(cast, state["master"], params)
    new_state = {"m": state["m"], "v": state["v"], "master": state["master"],
                 "step": step, "err": state.get("err")}
    return new_params, new_state, {"grad_norm": gnorm}
