"""(architecture x shape x mesh) cells, the port's counterpart of
``repro/launch/cells.py``: a step function, its abstract arguments
(``meta`` tensors, no allocation) and their placements.

Every cell runs one of:
  train_step  — fwd+bwd+AdamW (microbatched, remat, ZeRO-1)   [train_4k]
  prefill     — full-context prefill returning logits+cache   [prefill_32k]
  serve_step  — one decode token against a seq_len KV cache   [decode_32k, long_500k]

On a mesh the parameters, the optimizer state and the caches are DTensors
placed by ``param_specs()``, ``opt_state_specs()`` and ``cache_specs()`` (the
``in_shardings``, where the reference has ``NamedSharding``s), and the model
runs tensor-parallel (``distributed/tensor_parallel.py``). A train cell with
``train_layout="fsdp"`` runs the fully sharded layout instead (``fsdp_pc``):
every mesh axis carries the batch, the parameters are sharded by
``zero1_spec`` over all of them and gathered per layer group. The batch
inputs are every rank's whole (``None`` in ``in_shardings``): each rank
takes its rows, after the train step's microbatch split, as the reference
splits the global batch.

``trace_cell`` takes the place of ``lower_cell``: it runs the cell once on
this rank under ``FakeTensorMode`` (no memory, no arithmetic), counting the
FLOPs of its matrix products, recording its collectives and tracking its
peak memory (``torch.distributed._tools.mem_tracker.MemTracker``). A
hand-written kernel cannot run on fake tensors, so a traced prefill attends
through the model's plain blockwise path, as the reference's dry run lowers
its plain jnp attention (``repro/models/layers.py``); a cell's model prefills
so by default, as the reference's cells do. A cell run for real on the card
(``materialize``) goes through ``use_kernels`` first: its prefill then
launches ``flash_prefill``.

``CellStep`` takes the place of ``lower_cell(...).compile()``: a built,
materialised cell as a step captured once as a CUDA graph and replayed
(``engine/graphs.py``). A train cell goes through the captured train step
(``training/train_step.py::TrainStep``), a prefill or decode cell through
``graphs.capture`` with its parameters (and a decode's cache, updated in
place) held where they are and its token inputs static; ``flash_prefill``'s
TMA maps are baked in at capture, as in the paged prefill graphs.

A fake-tensor trace costs host time per operator, so a full-depth cell at
production shapes takes minutes. ``trace_composed`` traces the cell at two
and three layer groups and composes the full depth: the FLOPs and the
collectives from the third group's increment (exact: a trace counts them
layer by layer), the peak point by point (``composed_peak``). Each trace
keeps the step's timeline: after every operator, the operator, whether it
ran in the backward, and the bytes then held. ``match_steps`` lines the two
timelines up: each run of forward operators, and each of backward ones, at
three groups is the run at two with one group's block inserted, so every
operator at two groups has its counterpart at three, the same point of the
step. At each point the bytes held grow by the three-group trace's
increment per further group; the composed peak is the largest of those,
and never below either traced peak. Two peaks alone do not compose: a
ZeRO-1 train step peaks in the backward at two groups and at the end of
the forward at three. For qwen3-1.7b's train, prefill and decode cells, on
a (2, 2, 2) mesh at smoke size (tests/test_torch_kernels_ref.py) and at
production size on (16, 16) and (2, 16, 16) (PERF.md §6), the composed
peak equals a trace of every layer.

DTensor's sharding propagation stays out of the bytes held. On a miss of
its cache it runs an operator once more at its global shape, under the
active ``FakeTensorMode``, to find the output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``). Under a trace
that mode is the trace's own, so ``MemTracker`` would count those
global-shape inputs and outputs as held (torch 2.11 counts every operator;
2.13 leaves out those run under another fake mode than the one active
when it was entered, and the propagation reuses that one). A process's
first trace of a shape misses most, so its peak would depend on what the
process traced before: at smoke size on (2, 2, 2) up to 5.7% more than a
later trace of the same shape, and on a 512-rank mesh an operator's global
shape is 512 ranks' worth. Left out, as ``_propagation_untracked`` does,
every trace reads what the card would hold, where the propagation runs on
a fake mode of its own and holds no device memory.
"""
from __future__ import annotations

import contextlib
import math
import time
from array import array
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import ParallelConfig, placements
from repro_torch.engine import graphs
from repro_torch.launch.hlo_stats import (
    CollectiveRecord, CollectiveRecorder, CollectiveStats, collective_stats,
    dot_flops)
from repro_torch.models.param_utils import tree_flatten, tree_map
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import (
    abstract_opt_state, init_opt_state, opt_state_specs, zero1_spec)
from repro_torch.training.train_step import TrainConfig, TrainStep, make_train_step

WHISPER_PROMPT_LEN = 64          # decoder prompt tokens at prefill

# per-arch gradient accumulation for train_4k (the reference's fit-to-memory
# knob, kept so that the cells are the same steps)
TRAIN_GRAD_ACCUM: Dict[str, int] = {
    "qwen2.5-32b": 4,
    "internvl2-26b": 4,
    "gemma3-12b": 2,
    "qwen3-moe-30b-a3b": 2,
    "rwkv6-7b": 2,
    "hymba-1.5b": 2,
    "qwen3-1.7b": 2,
}

def effective_pc(mesh, global_batch: int) -> ParallelConfig:
    """Drop DP batch sharding when the batch doesn't divide it (long_500k B=1)."""
    pc = ParallelConfig.from_mesh(mesh)
    if global_batch % max(pc.dp, 1) != 0:
        return ParallelConfig(dp_axes=(), tp_axis=pc.tp_axis, tp=pc.tp, dp=1)
    return pc


def fsdp_pc(mesh) -> ParallelConfig:
    """The fully sharded layout: every mesh axis carries the batch, no model
    axis; parameters are sharded by ``zero1_spec`` over all axes and
    gathered per layer group."""
    names = tuple(mesh.mesh_dim_names)
    return ParallelConfig(dp_axes=names, tp_axis=None, tp=1,
                          dp=math.prod(mesh.shape))


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    kind: str                    # train | prefill | serve
    fn: Any
    args: Tuple                  # trees of meta tensors (global shapes)
    in_shardings: Optional[Tuple]   # trees of PartitionSpecs (None: whole)
    donate_argnums: Tuple[int, ...]
    model: Any
    pc: ParallelConfig
    train_config: Optional[TrainConfig] = None   # a train cell's


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: str, shape_name: str, mesh=None,
               cfg_override: Optional[ModelConfig] = None,
               train_layout: str = "tp", compress_grads: bool = False, *,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """``shape`` replaces the registry's ``shape_name`` (a cut of it)."""
    cfg = cfg_override or get_config(arch)
    shape = shape or get_shape(shape_name)
    if not cfg.supports_shape(shape):
        raise ValueError(f"{arch} skips {shape_name} (see DESIGN.md §5)")
    fsdp = mesh is not None and shape.kind == "train" and train_layout == "fsdp"
    if mesh is None:
        pc = ParallelConfig.single_device()
    elif fsdp:
        pc = fsdp_pc(mesh)
        if shape.global_batch % pc.dp:
            raise ValueError(f"FSDP needs the batch ({shape.global_batch}) "
                             f"divisible by the {pc.dp} devices")
    else:
        pc = effective_pc(mesh, shape.global_batch)
    model = build_model(cfg, pc)
    model.mesh = mesh
    B, S = shape.global_batch, shape.seq_len
    params = model.abstract_params()
    p_specs = model.param_specs() if mesh is not None else None

    if shape.kind == "train":
        ga = 1 if train_layout == "fsdp" else TRAIN_GRAD_ACCUM.get(arch, 1)
        if fsdp:
            p_specs = tree_map(lambda sp, a: zero1_spec(sp, a.shape, pc),
                               p_specs, params)
        tc = TrainConfig(grad_accum=ga, compress_grads=compress_grads)
        step = make_train_step(model, tc)
        opt = abstract_opt_state(params)
        # the step counter stays a plain tensor on every rank
        opt_sh = dict(opt_state_specs(p_specs, params, pc), step=None) \
            if mesh is not None else None
        batch = _train_batch(cfg, B, S)
        return Cell(arch, shape, "train", step, (params, opt, batch),
                    (p_specs, opt_sh, None) if mesh is not None else None,
                    (0, 1), model, pc, tc)

    if shape.kind == "prefill":
        return _prefill_cell(arch, cfg, model, shape, B, S, pc, mesh, params,
                             p_specs)

    # decode / long_decode -> serve_step
    cache = model.cache_struct(B, S)
    cache_sh = model.cache_specs() if mesh is not None else None

    def serve_step(p, c, t, pos):
        return model.decode_step(p, c, t, pos)

    return Cell(arch, shape, "serve", serve_step,
                (params, cache, _meta((B,)), _meta((B,))),
                (p_specs, cache_sh, None, None) if mesh is not None else None,
                (1,), model, pc)


def _train_batch(cfg, B, S):
    bf16 = torch.bfloat16
    if cfg.is_encoder_decoder:
        T = cfg.max_target_len
        return {"frames": _meta((B, S, cfg.d_model), bf16),
                "tokens": _meta((B, T)), "labels": _meta((B, T))}
    if cfg.num_vision_patches > 0:
        Pch = cfg.num_vision_patches
        return {"tokens": _meta((B, S - Pch)), "labels": _meta((B, S)),
                "extra_embeds": _meta((B, Pch, cfg.d_model), bf16)}
    return {"tokens": _meta((B, S)), "labels": _meta((B, S))}


def _prefill_cell(arch, cfg, model, shape, B, S, pc, mesh, params, p_specs):
    bf16 = torch.bfloat16
    seq_lens = _meta((B,))
    if cfg.is_encoder_decoder:
        frames = _meta((B, S, cfg.d_model), bf16)
        tokens = _meta((B, WHISPER_PROMPT_LEN))

        def prefill(p, t, f, sl):
            return model.prefill(p, t, frames=f, seq_lens=sl)
        args = (params, tokens, frames, seq_lens)
    elif cfg.num_vision_patches > 0:
        Pch = cfg.num_vision_patches
        tokens = _meta((B, S - Pch))
        extra = _meta((B, Pch, cfg.d_model), bf16)

        def prefill(p, t, e, sl):
            return model.prefill(p, t, extra_embeds=e, seq_lens=sl, max_len=S)
        args = (params, tokens, extra, seq_lens)
    else:
        def prefill(p, t, sl):
            return model.prefill(p, t, seq_lens=sl, max_len=S)
        args = (params, _meta((B, S)), seq_lens)
    in_sh = (p_specs,) + (None,) * (len(args) - 1) if mesh is not None else None
    return Cell(arch, shape, "prefill", prefill, args, in_sh, (), model, pc)


# --------------------------------------------------------------------------
# arguments: fake (traced) or real (run on the card)
# --------------------------------------------------------------------------
def _local_shape(shape, pl, mesh):
    out = list(shape)
    for i, p in enumerate(pl):
        if hasattr(p, "dim"):
            out[p.dim] //= mesh.size(i)
    return out


def _place(tree, specs, mesh, new):
    """Each meta leaf of ``tree`` as ``new(shape, dtype)``: this rank's shard
    wrapped as a DTensor where ``specs`` places it on ``mesh``, the whole
    tensor elsewhere."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, specs[k] if specs is not None else None, mesh, new)
                for k, v in tree.items()}
    if specs is None or mesh is None:
        return new(tuple(tree.shape), tree.dtype)
    pl = placements(specs, mesh, tree.shape)
    local = new(tuple(_local_shape(tree.shape, pl, mesh)), tree.dtype)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def abstract_args(cell: Cell, device):
    """The cell's arguments as uninitialised tensors on ``device`` (fake
    ones under ``FakeTensorMode``), placed by its ``in_shardings``."""
    mesh = cell.model.mesh
    specs = cell.in_shardings or (None,) * len(cell.args)
    return tuple(_place(a, s, mesh, lambda shp, dt: torch.empty(
        shp, dtype=dt, device=device)) for a, s in zip(cell.args, specs))


def use_kernels(cell: Cell) -> Cell:
    """The cell with its model's prefill attending through ``flash_prefill``
    (the kernel on CUDA tensors), where the cell's own is the plain
    blockwise path, as the reference's cells. The kernel masks causally
    only: rows past a prompt's length differ, and with them an MoE layer's
    routes where slots drop (a pad row takes capacity)."""
    if hasattr(cell.model, "with_prefill_attn"):
        cell.model.prefill_attn_impl = "flash"
    return cell


def materialize(cell: Cell, device, seed: int = 0):
    """The cell's arguments for a real run at ``mesh=None``: parameters from
    ``init_params`` with a generator seeded ``seed``, the optimizer state of
    those parameters, token inputs drawn below the vocab size, lengths equal
    to the sequence, zero caches and bf16 inputs drawn normal."""
    if cell.model.mesh is not None:
        raise ValueError("materialize runs a cell at mesh=None")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cell.model.init_params(gen)
    cfg, S = cell.model.cfg, cell.shape.seq_len

    def draw(x):
        if x.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, tuple(x.shape),
                                 generator=gen, dtype=torch.int32, device=device)
        return torch.randn(tuple(x.shape), generator=gen, dtype=torch.float32,
                           device=device).to(x.dtype)

    def full(x, v):
        return torch.full(tuple(x.shape), v, dtype=x.dtype, device=device)

    if cell.kind == "train":
        return (params, init_opt_state(params), tree_map(draw, cell.args[2]))
    if cell.kind == "serve":      # one token after S - 1 cached ones
        cache = tree_map(lambda x: torch.zeros(tuple(x.shape), dtype=x.dtype,
                                               device=device), cell.args[1])
        return (params, cache, draw(cell.args[2]), full(cell.args[3], S - 1))
    # prefill: every row S long
    return ((params,) + tuple(draw(a) for a in cell.args[1:-1])
            + (full(cell.args[-1], S),))


class CellStep:
    """A materialised cell (``args`` from ``materialize``) as a replayable
    step, the counterpart of the reference's ``lower_cell`` + ``.compile()``.
    On CUDA the constructor runs the cell once (the warm-up, a real step)
    and captures it; ``eager=True``, or the CPU, calls the cell at every
    step instead. ``step()`` copies the cell's token inputs
    (and a train cell's batch) from the host and replays: a train cell
    returns ``{"loss", "grad_norm"}`` (its parameters and optimizer state
    updated in place), a prefill ``(logits, cache)``, a decode ``(logits,
    cache)`` with the cache written in place. ``capture_s`` is the
    capture's seconds, the warm-up not counted; ``pool`` the graph's
    memory pool (None when eager). Raises if a capture fails."""

    def __init__(self, cell: Cell, args, *, eager: bool = False):
        if cell.model.mesh is not None:
            raise ValueError("a CellStep runs a cell at mesh=None")
        self.cell = cell
        device = tree_flatten(args[0])[1][0].device
        if cell.kind == "train":
            params, opt, batch = args
            self.inputs = [{k: v.cpu() for k, v in batch.items()}]
            self._step = TrainStep(cell.model, cell.train_config, params, opt,
                                   eager=eager)
            if self._step.pool is not None:
                self._step(*self.inputs)
            self.capture_s, self.pool = self._step.capture_s, self._step.pool
            return
        params = args[0]
        if cell.kind == "serve":            # (params, cache, tokens, positions)
            cache = args[1]
            self.inputs = [a.cpu() for a in args[2:]]

            def fn(*inputs):
                return cell.fn(params, cache, *inputs)
        else:                               # (params, *inputs)
            cache = None
            self.inputs = [a.cpu() for a in args[1:]]

            def fn(*inputs):
                return cell.fn(params, *inputs)
        graphed = device.type == "cuda" and not eager
        self.pool = torch.cuda.graph_pool_handle() if graphed else None
        self._step, _ = graphs.capture(
            fn, self.inputs, device, pool=self.pool,
            stream=torch.cuda.Stream(device) if graphed else None)
        self.capture_s = self._step.capture_s
        if self._step.graph is not None and cache is not None and any(
                a is not b for a, b in zip(tree_flatten(self._step.outputs[1])[1],
                                           tree_flatten(cache)[1])):
            raise RuntimeError("a captured decode cell returned a cache other "
                               "than its own")

    def step(self):
        return self._step(*self.inputs)


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------
@dataclass
class CellTrace:
    dot_flops: float                 # per device
    flop_counts: Dict[str, int]      # FlopCounterMode's total per operator
    collectives: CollectiveStats
    records: list                    # hlo_stats.CollectiveRecord per call
    peak_bytes: int                  # MemTracker's peak on the device
    seconds: float
    composed_from: Optional[Tuple[int, int]] = None   # layers of the two traces
    traced_peaks: Optional[Tuple[int, int]] = None    # the two traces' peaks
    # the step's timeline (``_step_tracker``): (op, in the backward) of each
    # operator and the bytes held after it; None on a composed trace
    timeline: Optional[Tuple[list, array]] = None


def _leaves(args):
    out = []
    for a in args:
        for x in tree_flatten(a)[1] if isinstance(a, dict) else [a]:
            out.append(x.to_local() if isinstance(x, DTensor) else x)
    return out


def _step_tracker():
    """A ``MemTracker`` that leaves DTensor's sharding propagation out
    (``_propagation_untracked``) and keeps the step's timeline: ``ops``,
    each operator it tracks as ``(op, in the backward)``, and ``held``, the
    bytes held after it. Metadata queries (``prim``) stay out of the
    timeline: a stacked tensor's ``unbind`` asks one per layer."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class StepTracker(MemTracker):
        def __init__(self):
            super().__init__()
            self.ops: list = []
            self.held = array("q")
            self.propagating = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.propagating:
                return func(*args, **(kwargs or {}))
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and func.namespace != "prim":
                bw = torch._C._current_graph_task_id() != -1
                self.ops.append((func, bw))
                self.held.append(sum(s["Total"] for s in
                                     self._curr_mem_snap.values()))
            return out

    return StepTracker()


@contextlib.contextmanager
def _propagation_untracked(tracker):
    """While inside, the ops that DTensor's sharding propagation runs to
    find an output's global shape pass ``tracker`` by. On a cache miss they
    run at the global shape under the active ``FakeTensorMode``, the trace's
    own, so a tracker would count their inputs and outputs as held (the
    module's docstring)."""
    sp = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(sp, name)

    def propagate(op_schema):
        tracker.propagating += 1
        try:
            return inner(op_schema)
        finally:
            tracker.propagating -= 1

    setattr(sp, name, propagate)
    try:
        yield
    finally:
        delattr(sp, name)


def trace_cell(cell: Cell, device=None) -> CellTrace:
    """Run ``cell.fn`` once on this rank on fake tensors; ``device`` is the
    fake tensors' (default: the card where there is one, else the CPU; on a
    mesh, the mesh's device type)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    mesh = cell.model.mesh
    if device is None:
        device = mesh.device_type if mesh is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    prev = getattr(cell.model, "prefill_attn_impl", None)
    if prev is not None:
        cell.model.prefill_attn_impl = "block"
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = abstract_args(cell, device)
            tracker = _step_tracker()
            tracker.track_external(*_leaves(args))
            flops = FlopCounterMode(display=False)
            rec = CollectiveRecorder()
            with _propagation_untracked(tracker), tracker, flops, rec:
                cell.fn(*args)
            peak = tracker.get_tracker_snapshot("peak")
    finally:
        if prev is not None:
            cell.model.prefill_attn_impl = prev
    counts = {getattr(op, "__name__", str(op)): int(n) for op, n in
              flops.get_flop_counts().get("Global", {}).items()}
    dev_peak = peak.get(device, {}) or next(iter(peak.values()), {})
    return CellTrace(dot_flops(flops), counts, collective_stats(rec.records),
                     rec.records, int(dev_peak.get("Total", 0)),
                     time.perf_counter() - t0,
                     timeline=(tracker.ops, tracker.held))


def _by_group(records) -> Dict[tuple, list]:
    out: Dict[tuple, list] = {}
    for r in records:
        calls, nbytes = out.get((r.kind, r.group_size, r.intra_node), (0, 0))
        out[(r.kind, r.group_size, r.intra_node)] = (calls + r.calls,
                                                     nbytes + r.out_bytes)
    return out


def _phases(ops) -> list:
    """``(start, end)`` of each run of forward or of backward operators."""
    cuts = [0] + [q for q in range(1, len(ops)) if ops[q][1] != ops[q - 1][1]]
    return list(zip(cuts, cuts[1:] + [len(ops)]))


def _common(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    diff = np.flatnonzero(a[:n] != b[:n])
    return int(diff[0]) if len(diff) else n


def match_steps(ops_a: list, ops_b: list):
    """Align step ``ops_a`` (n layer groups) with step ``ops_b`` (n + 1),
    operators given as ``(op, backward)``. Each run of forward operators,
    and each of backward ones, of ``b`` must be ``a``'s with one block
    inserted that repeats a block beside it (one layer group's forward, or
    its recomputation and backward), so that it can sit at any of at least
    ``len(block) + 1`` places. Of them the middle one is taken, where
    ``a``'s first group meets ``b``'s first and ``a``'s last ``b``'s last.
    Returns runs ``(i, j, n)`` with ``a[i:i+n] == b[j:j+n]`` that cover all
    of ``a``. Raises ``ValueError`` where the steps do not align so."""
    ids: Dict[tuple, int] = {}
    a, b = (np.fromiter((ids.setdefault(op, len(ids)) for op in ops),
                        dtype=np.int64, count=len(ops)) for ops in (ops_a, ops_b))
    pa, pb = _phases(ops_a), _phases(ops_b)
    if [ops_a[p][1] for p, _ in pa] != [ops_b[p][1] for p, _ in pb]:
        raise ValueError(f"the forward and backward phases differ: "
                         f"{len(pa)} and {len(pb)}")
    runs = []
    for (ia, ea), (jb, eb) in zip(pa, pb):
        x, y = a[ia:ea], b[jb:eb]
        g = len(y) - len(x)
        head = _common(x, y)
        tail = _common(x[::-1], y[::-1])
        if g < 0 or head + tail < len(x):
            raise ValueError(f"the phase at operator {ia} is not the deeper "
                             f"step's with one block inserted")
        if g == 0:
            runs.append((ia, jb, len(x)))
            continue
        lo, hi = len(x) - tail, head          # the splits x[:s] | x[s:]
        if hi - lo < g:      # one group's copy in x lets it slide g places
            raise ValueError(f"the {g} operators inserted at {jb + lo} "
                             f"repeat no block of the shallower step: not "
                             f"one layer group")
        s = (lo + hi) // 2
        runs += [(ia, jb, s), (ia + s, jb + s + g, len(x) - s)]
    return runs


def composed_peak(t1: CellTrace, t2: CellTrace, k: int) -> int:
    """The peak of the step ``k`` layer groups deeper than ``t2``, from the
    timelines of ``t1`` and ``t2`` (n and n + 1 groups): at each operator
    of ``t1`` and its counterpart in ``t2`` (``match_steps``), the bytes
    held grow by ``t2``'s increment over ``t1`` per group; the largest.
    Raises ``ValueError`` where the steps do not align, or where that
    largest is below either trace's own peak."""
    va = np.frombuffer(t1.timeline[1], dtype=np.int64)
    vb = np.frombuffer(t2.timeline[1], dtype=np.int64)
    runs = match_steps(t1.timeline[0], t2.timeline[0])
    peak = max((int((vb[j:j + n] + k * (vb[j:j + n] - va[i:i + n])).max())
                for i, j, n in runs if n), default=0)
    if peak < max(t1.peak_bytes, t2.peak_bytes):
        raise ValueError(f"the composed peak {peak} B is below a traced "
                         f"one ({t1.peak_bytes}, {t2.peak_bytes} B)")
    return peak


def compose(t1: CellTrace, t2: CellTrace, k: int) -> CellTrace:
    """``t2`` plus ``k`` times its increment over ``t1`` (the traces of a
    cell at n and n + 1 layer groups; ``k`` more groups). The collectives
    compose per kind and group: calls and output bytes; the peak by
    ``composed_peak``."""
    a1, a2 = _by_group(t1.records), _by_group(t2.records)
    if set(a1) - set(a2):
        raise ValueError("a group's collectives are not a superset: the "
                         "trace does not grow layer by layer")
    records = []
    for key, (calls, nbytes) in a2.items():
        c1, b1 = a1.get(key, (0, 0))
        records.append(CollectiveRecord(
            key[0], nbytes + k * (nbytes - b1), key[1], key[2],
            calls + k * (calls - c1)))
    flops = {op: n + k * (n - t1.flop_counts.get(op, 0))
             for op, n in t2.flop_counts.items()}
    return CellTrace(t2.dot_flops + k * (t2.dot_flops - t1.dot_flops), flops,
                     collective_stats(records), records,
                     composed_peak(t1, t2, k), t1.seconds + t2.seconds,
                     traced_peaks=(t1.peak_bytes, t2.peak_bytes))


def trace_composed(arch: str, shape_name: str, mesh=None,
                   cfg_override: Optional[ModelConfig] = None, *,
                   shape: Optional[ShapeConfig] = None, device=None,
                   whole: bool = False) -> CellTrace:
    """The cell's trace at full depth, composed from traces at two and three
    layer groups (``compose``; ``composed_from`` gives their layers,
    ``traced_peaks`` their peaks); a model of at most three groups, or any
    with ``whole``, is traced whole. The one trace behind
    ``roofline.roofline_row`` and ``dryrun.run_cell``. Raises
    ``ValueError``, naming the cell, where the two traces do not compose."""
    cfg = cfg_override or get_config(arch)
    cell = build_cell(arch, shape_name, mesh, cfg_override=cfg, shape=shape)
    g = cell.model.layers_per_scan_step
    groups = cfg.num_layers // g
    if groups <= 3 or whole:
        return trace_cell(cell, device)
    t2, t3 = (trace_cell(build_cell(arch, shape_name, mesh, shape=shape,
                                    cfg_override=cfg.replace(num_layers=n * g)),
                         device) for n in (2, 3))
    try:
        out = compose(t2, t3, groups - 3)
    except ValueError as e:
        raise ValueError(f"{arch} x {shape_name}: {e}") from None
    out.composed_from = (2 * g, 3 * g)
    return out
