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

``TrainStep`` is the counterpart of the reference's ``jax.jit(
make_train_step(model, tc), donate_argnums=(0, 1))`` on one device: the
in-place step (``make_train_step(..., in_place=True)``, every tensor the
reference donates written where it is) captured once as a CUDA graph
(``engine/graphs.py``), the gradient accumulation loop, the compression,
the norm and clip and AdamW's update of every leaf inside it; each later
step is one input copy and one replay. On the CPU the same object calls the
in-place step eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.engine import graphs
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


def consume(fn, tree, *rest):
    """``tree_map(fn, tree, *rest)`` over trees that the caller gives up:
    each leaf is taken out of its tree as ``fn`` reaches it, so that it can
    be freed once its result exists. Gradient trees of a model's size are
    summed so with about two of them held, not three."""
    out = {}
    for k in list(tree):
        if isinstance(tree[k], dict):
            out[k] = consume(fn, tree[k], *(r[k] for r in rest))
        else:
            out[k] = fn(tree.pop(k), *(r.pop(k) for r in rest))
    return out


def init_err(opt_state):
    """The error feedback before the first compressed step on one device:
    float32 zeros of each gradient's shape (``m``'s), what the first step
    makes where ``err`` is None."""
    return tree_map(torch.zeros_like, opt_state["m"])


def make_train_step(model, tc: TrainConfig, *, in_place: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``opt_state`` is updated in place (see ``adamw_update``),
    the caller's ``params`` are not. With ``in_place`` the step writes
    every tensor the reference donates where it is, the parameters, the
    step counter and the error feedback too (``err`` must exist:
    ``init_err``), and returns the trees it was given."""

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
                grads = g_i if i == 0 else consume(leafwise(torch.add),
                                                   grads, g_i)
                loss = loss + l_i
            grads = consume(leafwise(lambda g: g / ga), grads)
            loss = loss / ga

        if tc.compress_grads:
            # the quantization error re-enters the next step's gradients
            # instead of vanishing
            err = opt_state.get("err")
            if err is None:
                if in_place:
                    raise ValueError("an in-place step with compress_grads "
                                     "needs opt_state['err'] (init_err)")
                err = tree_map(leafwise(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device)), grads)
            g32 = tree_map(leafwise(lambda g, e: g.float() + e), grads, err)
            gq = tree_map(leafwise(lambda g: g.to(torch.bfloat16)), g32)
            new_err = tree_map(leafwise(lambda g, q: g - q.float()), g32, gq)
            grads = gq
            if in_place:
                tree_map(leafwise(torch.Tensor.copy_), err, new_err)
            else:
                opt_state = dict(opt_state, err=new_err)

        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, tc.adamw, in_place=in_place)
        return new_params, new_opt, {"loss": loss, **opt_metrics}

    return train_step


class TrainStep:
    """One device's train step over the live trees ``params`` and
    ``opt_state``, which it owns and updates in place (the module
    docstring). ``step(batch)`` takes host arrays (numpy or CPU tensors)
    and returns ``{"loss", "grad_norm"}`` as device scalars.

    On CUDA the first call is the warm-up, a real step run eagerly on the
    capture stream; then the allocator's cache is released (the warm-up's
    transient memory would sit beside the pool's copy of it) and the step
    is captured into a private pool. Every later call copies the batch into
    the step's static inputs (one pinned copy) and replays the graph. A
    failed capture raises. ``eager=True`` calls the in-place step at every
    call instead, as on the CPU. Every batch has the first one's keys,
    shapes and dtypes. ``capture_s`` is the capture's seconds (the warm-up
    not counted), ``pool`` the graph's memory pool (None when eager)."""

    def __init__(self, model, tc: TrainConfig, params, opt_state, *,
                 eager: bool = False):
        self.params, self.opt = params, opt_state
        if tc.compress_grads and opt_state.get("err") is None:
            opt_state["err"] = init_err(opt_state)
        self.device = tree_flatten(params)[1][0].device
        self._fn = make_train_step(model, tc, in_place=True)
        graphed = self.device.type == "cuda" and not eager
        self.pool = torch.cuda.graph_pool_handle() if graphed else None
        self._stream = torch.cuda.Stream(self.device) if graphed else None
        self.keys = None
        self.step = None           # graphs.Step, made at the first call
        self.capture_s = 0.0

    @property
    def trees(self):
        return {"params": self.params, "opt": self.opt}

    def __call__(self, batch):
        if self.step is None:
            self.keys = keys = list(batch)
            arrays = [batch[k] for k in keys]
            step_fn, trees = self._fn, self.trees

            def run(*inputs):   # holds no reference to self: no cycle
                _, _, m = step_fn(trees["params"], trees["opt"],
                                  dict(zip(keys, inputs)))
                return (m["loss"], m["grad_norm"]), trees

            self.step = graphs.Step(run, graphs.specs_of(arrays), self.device)
            if self.pool is not None:
                return self._warm_up_and_capture(arrays)
        (loss, gnorm), _ = self.step(*(batch[k] for k in self.keys))
        return {"loss": loss, "grad_norm": gnorm}

    def _warm_up_and_capture(self, arrays):
        self.step.load(arrays)
        self.step.calls += 1
        loss, gnorm = self.step.capture(self.pool, self._stream, release=True)
        self.capture_s = self.step.capture_s
        live, out = tree_flatten(self.trees), tree_flatten(self.step.outputs[1])
        if live[0] != out[0] or any(a is not b for a, b in zip(live[1], out[1])):
            raise RuntimeError("the captured train step returned tensors "
                               "other than its live trees")
        return {"loss": loss, "grad_norm": gnorm}

    @torch.no_grad()
    def load_state(self, trees) -> None:
        """Copy ``trees`` (``{"params", "opt"}``, e.g. a checkpoint's, on
        any device) into the live trees, where every replay reads them."""
        for name, live in self.trees.items():
            (pa, la), (pb, lb) = tree_flatten(live), tree_flatten(trees[name])
            if pa != pb:
                raise ValueError(f"{name}: the trees' leaves differ")
            for a, b in zip(la, lb):
                a.copy_(b)
