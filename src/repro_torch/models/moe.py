"""Mixture-of-Experts transformer (qwen3-moe, granite-moe), the PyTorch
counterpart of ``repro/models/moe.py``: ``moe_dispatch``,
``moe_dispatch_local_ep`` (expert-parallel on a ``DeviceMesh``) and
``MoETransformer``.

Expert dispatch uses the reference's *grouped-capacity* scheme: the
token-expert slots are sorted by expert (stably), packed into an
``[E, C, D]`` buffer (capacity C from the capacity factor; a slot ranked
past C within its expert is dropped), run through three batched matrix
products and gathered back, weighted by the router. The batched products are
plain matrix products, as the reference's ``einsum`` is outside any Pallas
kernel, so ``torch.bmm`` computes them.

Every step is a gather, a sort or a reduction, never a scatter-add, so two
runs of one batch give the same bits on CUDA too: the packing gathers each
(expert, rank) cell's token, and the combine un-permutes the slot outputs to
``[T, k, D]`` and sums over ``k``. That sum is not the reference's
arithmetic in bf16: torch sums the ``k`` outputs in float32 and rounds once,
where the reference's ``.at[tok].add`` rounds to bf16 after each add, in
expert-sorted order. In float32 the two differ only in the order of the
adds. Capacity drops make a token's output
depend on the rest of its batch (pad rows are routed too), as in the
reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import dp_rank, round_up
from repro_torch.models import layers as L
from repro_torch.models.param_utils import map_templates, t
from repro_torch.models.transformer import DenseTransformer


class Route(NamedTuple):
    """Where each token-expert slot goes. ``top_w``/``top_i`` [T, k]: the
    renormalised router weights and experts; ``aux``: the switch-style
    load-balancing loss; ``tok_cell`` [Ep, C]: the token packed into cell
    (e, c), or T for an empty cell; ``dest`` [T * k]: each slot's cell
    ``e * C + c``, or ``Ep * C`` for a slot dropped past capacity."""
    top_w: torch.Tensor
    top_i: torch.Tensor
    aux: torch.Tensor
    tok_cell: torch.Tensor
    dest: torch.Tensor
    capacity: int


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``idx < n``, in a tensor of
    static shape (a fake-tensor trace takes no output shape that depends
    on the data)."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def moe_route(x: torch.Tensor, router_w: torch.Tensor, num_padded: int, *,
              top_k: int, capacity_factor: float) -> Route:
    """Router softmax in float32, top-k, renormalisation, aux loss, and the
    reference's capacity assignment: slots stably sorted by expert, ranked
    within their expert, and dropped from rank C on."""
    T = x.shape[0]
    E = router_w.shape[1]
    Ep = num_padded
    dev = x.device
    logits = (x @ router_w).float()                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable descending sort: ties go to the lower expert index
    # first, as jax.lax.top_k orders them
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]    # [T, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # ---- aux loss (switch-style load balancing) ----
    frac_tokens = _counts(top_i[:, 0], E).float() / T
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))

    # ---- sort token-expert slots by expert, rank within the expert ----
    TK = T * top_k
    eid = top_i.reshape(TK)                               # expert per slot
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    tok_s = torch.div(order, top_k, rounding_mode="floor")  # token per sorted slot
    first = torch.searchsorted(eid_s, torch.arange(Ep, device=dev))
    rank = torch.arange(TK, device=dev) - first[eid_s]
    C = int(round_up(max(8, math.ceil(T * top_k / E * capacity_factor)), 8))

    # cell (e, c) holds the c-th slot routed to expert e, or nothing (T)
    count = _counts(eid, Ep)
    cells = torch.arange(C, device=dev)
    src = (first[:, None] + cells[None, :]).clamp(max=TK - 1)         # [Ep, C]
    tok_cell = torch.where(cells[None, :] < count[:, None], tok_s[src], T)
    dest_s = torch.where(rank < C, eid_s * C + rank, Ep * C)
    dest = torch.empty_like(dest_s)
    dest[order] = dest_s                                  # back to [T*k] order
    return Route(top_w, top_i, aux, tok_cell, dest, C)


def moe_dispatch(
    x: torch.Tensor,          # [T, D] tokens (flattened batch*seq)
    router_w: torch.Tensor,   # [D, E]
    w_gate: torch.Tensor,     # [Ep, D, F] Ep >= E: pad experts, zero weights
    w_up: torch.Tensor,       # [Ep, D, F]
    w_down: torch.Tensor,     # [Ep, F, D]
    *,
    top_k: int,
    capacity_factor: float,
    act: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [T, D], aux load-balancing loss, a float32 scalar). Pad
    experts (index >= E) exist only in the grouped products and are never
    routed to."""
    T, D = x.shape
    Ep = w_gate.shape[0]
    rt = moe_route(x, router_w, Ep, top_k=top_k,
                   capacity_factor=capacity_factor)
    # pack: a gather of each cell's token (row T is zeros)
    grouped = torch.cat([x, x.new_zeros((1, D))])[rt.tok_cell]      # [Ep, C, D]
    f = L.act_fn(act)
    h = f(torch.bmm(grouped, w_gate)) * torch.bmm(grouped, w_up)
    out_g = torch.bmm(h, w_down).reshape(Ep * rt.capacity, D)
    # combine: each slot reads its cell (row Ep * C is zeros: a dropped
    # slot), in the slots' own [T, k] order, and the k weighted outputs sum
    # per token
    out_g = torch.cat([out_g, out_g.new_zeros((1, D))])
    gathered = out_g[rt.dest] * rt.top_w.reshape(-1, 1).to(x.dtype)
    return gathered.reshape(T, top_k, D).sum(dim=1), rt.aux


def moe_dispatch_local_ep(
    x: torch.Tensor,          # [T_loc, D] this rank's data shard of the tokens
    router_w: torch.Tensor,   # [D, E]
    w_gate: torch.Tensor,     # [E_loc, D, F] this rank's experts (Ep / tp)
    w_up: torch.Tensor,       # [E_loc, D, F]
    w_down: torch.Tensor,     # [E_loc, F, D]
    *,
    top_k: int,
    capacity_factor: float,
    act: str,
    mesh,
    pc,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch with no token exchange, the counterpart of
    the reference's ``shard_map``: every rank of the ``pc.tp_axis`` group
    holds the same tokens (its data shard, replicated over the model axis)
    and the weights of experts ``[m * E_loc, (m + 1) * E_loc)``, ``m`` its
    index on that axis. It routes all its tokens (capacity C from its own
    T_loc), keeps the slots routed to its experts, runs the grouped products
    on them, and one all-reduce (sum) over the model axis combines the
    per-expert partial outputs. The aux loss is averaged over the model axis
    only, as the reference's ``pmean``: at dp > 1 each data shard keeps its
    own value. The collectives are ``tensor_parallel``'s: ``x`` and the
    router weights enter the model axis's region (their gradients summed
    over it), the output and the aux loss are reduced from it.

    Within an expert the slots keep their token order (a stable sort), so a
    rank's cells are the rows ``[m * E_loc, (m + 1) * E_loc)`` of the
    single-device route's cells over the same tokens, and a slot's cell there
    is its global cell less ``m * E_loc * C``: ``moe_route`` is reused as it
    is (and replayed by callers that patch it)."""
    T, D = x.shape
    E_loc = w_gate.shape[0]
    m = mesh.get_local_rank(pc.tp_axis)
    group = mesh.get_group(pc.tp_axis)
    x, router_w = TP.enter(x, group), TP.enter(router_w, group)
    rt = moe_route(x, router_w, E_loc * pc.tp, top_k=top_k,
                   capacity_factor=capacity_factor)
    C = rt.capacity
    lo = m * E_loc
    grouped = torch.cat([x, x.new_zeros((1, D))])[rt.tok_cell[lo:lo + E_loc]]
    f = L.act_fn(act)
    h = f(torch.bmm(grouped, w_gate)) * torch.bmm(grouped, w_up)
    out_g = torch.bmm(h, w_down).reshape(E_loc * C, D)
    out_g = torch.cat([out_g, out_g.new_zeros((1, D))])
    dest = rt.dest - lo * C
    dest = torch.where((dest >= 0) & (dest < E_loc * C), dest, E_loc * C)
    gathered = out_g[dest] * rt.top_w.reshape(-1, 1).to(x.dtype)
    out = TP.reduce(gathered.reshape(T, top_k, D).sum(dim=1), group)
    return out, TP.reduce(rt.aux, group) / pc.tp


class MoETransformer(DenseTransformer):
    """Dense transformer with the MLP swapped for grouped-capacity MoE.

    With ``mesh`` set (a ``DeviceMesh`` whose model axis is ``pc.tp_axis``),
    the MLP runs ``moe_dispatch_local_ep``. Given DTensor parameters placed
    by ``param_specs()``, the model runs tensor-parallel as
    ``DenseTransformer`` does, the experts on the model axis. Given each
    rank's plain tensors placed by ``ep_param_specs()`` (the attention and
    dense weights replicated, the experts its own shard), it runs on each
    rank over the rows of the batch it is given, with no other
    collective."""

    mesh = None   # set by the caller for the expert-parallel dispatch

    @property
    def padded_experts(self) -> int:
        """Experts in the grouped products, padded to a TP multiple with
        zero-weight experts that the router never picks."""
        e = self.cfg.num_experts
        return round_up(e, self.pc.tp) if self.pc.tp > 1 else e

    def ep_param_specs(self):
        """Specs of the local expert-parallel layout: the expert dims on the
        model axis, every other dim replicated."""
        return map_templates(
            lambda tm: self.pc.spec(*(n if n == "expert" else None
                                      for n in tm.logical)),
            self.templates())

    def _mlp_templates(self):
        cfg = self.cfg
        G, Pg, D, F = self.n_groups, self.group, cfg.d_model, cfg.d_ff
        E, Ep = cfg.num_experts, self.padded_experts

        def init_expert(fan_in):
            def f(gen, n):  # pad experts (index >= E) carry zero weights
                shape = (n, Pg, Ep, D, F) if fan_in == D else (n, Pg, Ep, F, D)
                w = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device).div_(math.sqrt(fan_in))
                mask = (torch.arange(Ep, device=gen.device) < E).float()
                return w.mul_(mask[None, None, :, None, None])
            return f

        return {
            "router": t((G, Pg, D, E), (None, None, None, None), fan_in=D),
            "w_gate": t((G, Pg, Ep, D, F), (None, None, "expert", None, None),
                        custom=init_expert(D)),
            "w_up": t((G, Pg, Ep, D, F), (None, None, "expert", None, None),
                      custom=init_expert(D)),
            "w_down": t((G, Pg, Ep, F, D), (None, None, "expert", None, None),
                        custom=init_expert(F)),
        }

    def _aux_weight(self) -> float:
        return 0.01

    def _mlp(self, pp, p: int, x):
        cfg = self.cfg
        if self.pc.tp_axis is not None and self.mesh is not None:
            # local expert-parallel dispatch, no token exchange
            out, aux = moe_dispatch_local_ep(
                x.reshape(-1, cfg.d_model), pp["router"][p], pp["w_gate"][p],
                pp["w_up"][p], pp["w_down"][p], top_k=cfg.num_experts_per_tok,
                capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
                mesh=self.mesh, pc=self.pc)
            return out.reshape(x.shape), aux
        tokens = x.reshape(-1, cfg.d_model)
        n = tokens.shape[0]
        region = self._region
        # the fully sharded layout: the reference routes the whole batch
        # (capacity from all its tokens, in row order), so each rank routes
        # every rank's tokens and keeps its own rows' outputs
        fsdp = bool(region.dp_groups) and not region.active
        if fsdp:
            for g in reversed(region.dp_groups):
                tokens = TP.gather_scatter(tokens, g, 0)
        out, aux = moe_dispatch(
            tokens, pp["router"][p], pp["w_gate"][p],
            pp["w_up"][p], pp["w_down"][p], top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.act)
        if fsdp:
            out = out.narrow(0, dp_rank(self.mesh, self.pc) * n, n)
        return out.reshape(x.shape), aux
