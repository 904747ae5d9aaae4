"""AdamW with float32 master weights, the PyTorch counterpart of
``repro/training/optimizer.py`` on one device (its ZeRO-1 sharding,
``zero1_spec`` / ``opt_state_specs``, waits for the multi-device port).

The update is the reference's own formula, not ``torch.optim.AdamW``'s:
gradients clipped by their global norm, then
``master -= lr * (mhat / (sqrt(vhat) + eps) + weight_decay * master)``, then
every parameter cast to the first leaf's dtype (leaves in ``jax.tree_util``
order). Trees are nested dicts of tensors (``param_utils.tree_*``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_flatten(tree)[1]))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step on the float32 masters -> (params in the first leaf's
    dtype, state, metrics). ``state``'s m, v and master are updated in place
    (the reference's jit wrapper donates them); each is computed as the
    reference's expression, operation for operation."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    c1, c2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf

    def upd(g, m, v, master):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mhat, vhat = m / c1, v / c2
        master.sub_(cfg.lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                              + cfg.weight_decay * master))

    tree_map(upd, grads, state["m"], state["v"], state["master"])
    dtype = tree_flatten(params)[1][0].dtype
    new_params = tree_map(lambda w: w.to(dtype, copy=True), state["master"])
    new_state = {"m": state["m"], "v": state["v"], "master": state["master"],
                 "step": step, "err": state.get("err")}
    return new_params, new_state, {"grad_norm": gnorm}
