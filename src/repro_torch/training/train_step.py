"""Training step, the PyTorch counterpart of
``repro/training/train_step.py``: microbatched gradient accumulation (an
unrolled loop, accumulating in float32), remat through the model's layer
loop, optional bf16 gradient compression with error feedback, AdamW on
float32 masters. Gradients come from torch autograd on the explicit
parameter tree.

On a mesh the parameters are DTensors placed by ``param_specs()`` and the
optimizer state by ``opt_state_specs()`` (ZeRO-1): the model runs
tensor-parallel on each rank's rows and shards, each gradient comes back
``Partial`` over the data-parallel axes, and ``adamw_update`` reduce-scatters
it to the state's shard. The step's arithmetic on gradients is done on each
rank's local tensors, so their placements carry through. With
``compress_grads`` each microbatch's gradient is reduce-scattered to that
shard first, then rounded to bf16: the reference rounds its logical
gradient, the sum over the data-parallel ranks, not each rank's part of it;
the error feedback ``err`` lies on the same shards.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.param_utils import tree_flatten, tree_map, tree_unflatten
from repro_torch.training.optimizer import AdamWConfig, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    compress_grads: bool = False     # bf16 gradients with error feedback
    remat: bool = True
    adamw: AdamWConfig = AdamWConfig()


def loss_and_grads(model, params, batch, remat: bool):
    """(loss, grads) of ``model.train_loss`` at ``params``: every leaf gets a
    gradient of its own dtype (zeros where the loss does not reach it, as
    ``jax.grad`` gives)."""
    _, leaves = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.train_loss(tree_unflatten(params, live), batch, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def leafwise(fn):
    """``fn`` on leaves' local tensors; the result keeps the first leaf's
    DTensor placements (a ``Partial`` gradient stays one)."""
    def apply(x, *rest):
        if not isinstance(x, DTensor):
            return fn(x, *rest)
        out = fn(x.to_local(), *(r.to_local() for r in rest))
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return apply


def make_train_step(model, tc: TrainConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``opt_state`` is updated in place (see ``adamw_update``)."""

    def train_step(params, opt_state, batch):
        ga = tc.grad_accum
        acc_dtype = torch.bfloat16 if tc.compress_grads else torch.float32

        def cast(g, m):
            if tc.compress_grads and isinstance(m, DTensor):
                g = g.redistribute(m.device_mesh, m.placements)
            return leafwise(lambda x: x.to(acc_dtype))(g)

        if ga == 1:
            loss, grads = loss_and_grads(model, params, batch, tc.remat)
            grads = tree_map(cast, grads, opt_state["m"])
        else:
            micro = {k: v.reshape(ga, v.shape[0] // ga, *v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_flatten(params)[1][0].device)
            for i in range(ga):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, g_i = loss_and_grads(model, params, mb, tc.remat)
                g_i = tree_map(cast, g_i, opt_state["m"])
                # the first term is the sum's start: 0 + g is g
                grads = g_i if i == 0 else tree_map(leafwise(torch.add),
                                                    grads, g_i)
                loss = loss + l_i
            grads = tree_map(leafwise(lambda g: g / ga), grads)
            loss = loss / ga

        if tc.compress_grads:
            # the quantization error re-enters the next step's gradients
            # instead of vanishing
            err = opt_state.get("err")
            if err is None:
                err = tree_map(leafwise(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device)), grads)
            g32 = tree_map(leafwise(lambda g, e: g.float() + e), grads, err)
            gq = tree_map(leafwise(lambda g: g.to(torch.bfloat16)), g32)
            new_err = tree_map(leafwise(lambda g, q: g - q.float()), g32, gq)
            grads = gq
            opt_state = dict(opt_state, err=new_err)

        new_params, new_opt, opt_metrics = adamw_update(params, grads,
                                                        opt_state, tc.adamw)
        return new_params, new_opt, {"loss": loss, **opt_metrics}

    return train_step
