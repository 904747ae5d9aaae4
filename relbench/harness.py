"""One run of one benchmark cell of the port (``repro_torch``).

The cell's configuration, traffic mix and per-layer metrics are found by
name: ``BENCHMARK.json`` names them, ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py`` hold them. Nothing here
knows a cell.

A run:

1. set-up: the traffic from ``--seed`` (``traffic/gen.py``), the weights
   from ``--seed`` on the device (``weights.py``), the port's engine
   (``build_real_engine(..., "relserve", "paged", prefix_sharing=True,
   engine_loop="serial")``), one CUDA graph captured for every shape bucket
   the cell's traffic can reach, and a short serve of the cell's own
   traffic (its ``warmup`` stream) to warm the host paths;
2. the window of ``--seconds``, driven through ``EngineCore.admit`` and
   ``EngineCore.tick`` on the wall clock (seconds since the process
   started), by the mix's driver: ``open_loop`` admits each relQuery at its
   due time (or right after the tick in progress then) and times it from
   then; ``backlog`` admits the whole backlog before the window and counts
   the tokens the window completes;
3. the check: a sample of the finished rows, drawn from the seed with the
   longest among them, run through the plain reference
   (``reference/model.py``) once the program's state is freed; each served
   token's logit must lie within the configuration's limit of the
   reference's best.

``--trace 1`` runs the same, profiles the window's last seconds
(``profile.py``; a backlog is served on until the traced seconds are
over, and stopping the profiler, which takes a while, falls after the
window) and reports the per-layer metrics instead of the end-to-end
ones.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import sys
import time
import zlib
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from relbench import profile, weights
from relbench.reference.model import Reference, served_gap, served_positions
from relbench.traffic import gen

ROOT = Path(__file__).resolve().parents[1]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
REFERENCE_TOKENS = 8192       # tokens per reference pass
KERNELS = ("paged_attention", "flash_prefill")   # the paged path's kernels
TRACE_SECONDS = 3.0           # the traced sub-window: the window's last seconds


# ------------------------------------------------------------------ manifest
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    metrics: List[dict]       # the metrics this run reports, in order
    root: Path                # the checkout that holds them


def resolve(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and what a run of it
    reports: its end-to-end metrics, or with ``trace`` the per-layer
    metrics that list it (or, listing no cells, move one of its end-to-end
    metrics)."""
    man = load_json(root / "BENCHMARK.json")
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    cfg = load_json(root / entry["file"])
    mix = load_json(root / "relbench" / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if trace:
        mine = {m["name"] for m in e2e}
        chosen = [m for m in man["per_layer"]
                  if (name in m["workloads"] if "workloads" in m
                      else m["moves"] in mine)]
    else:
        chosen = e2e
    return Cell(wl, cfg, mix, chosen, root)


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``relbench/metrics/<name>.py``."""
    path = root / "relbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"relbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ the engine
def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn_kind="full", qkv_bias=weights.has_bias(cfg),
        rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        act=cfg["hidden_act"], dtype=cfg["torch_dtype"], source=cfg["source"])


def limits_of(cfg: dict):
    """Batch limits: the KV cap is the pool (``max_slots`` rows of
    ``max_len``), at most ``max_slots`` sequences; the rest the program's
    defaults."""
    from repro_torch.core.priority import BatchLimits
    srv = cfg["serving"]
    return BatchLimits(max_num_seqs=srv["max_slots"],
                       cap=srv["max_slots"] * srv["max_len"])


def build_engine(cfg: dict, params: dict, device, num_blocks: int):
    from repro_torch.models.registry import build_model
    from repro_torch.serving.factory import build_real_engine
    model = build_model(model_config(cfg))
    want = model.abstract_params()
    for name, x in [*params["blocks"].items(), *((k, v) for k, v in params.items()
                                                  if k != "blocks")]:
        ref = want["blocks"][name] if name in want["blocks"] else want[name]
        if tuple(ref.shape) != tuple(x.shape):
            raise ValueError(f"weight {name}: the benchmark draws "
                             f"{tuple(x.shape)}, the program takes "
                             f"{tuple(ref.shape)}")
    srv = cfg["serving"]
    return build_real_engine(
        cfg["name"], "relserve", "paged", limits=limits_of(cfg),
        prefix_sharing=True, max_slots=srv["max_slots"], max_len=srv["max_len"],
        block_size=srv["block_size"], num_blocks=num_blocks, model=model,
        params=params, engine_loop="serial", device=device)


def relqueries(specs: Sequence[gen.RelQuerySpec]) -> list:
    """The port's relQueries of the generated traffic (no EOS: every row
    emits its query type's output limit, so a seed fixes the work)."""
    from repro_torch.core.relquery import make_relquery
    return [make_relquery(s.rel_id, s.prompts, s.due, s.max_output_tokens,
                          template_id=f"{s.dataset}/{s.qtype}", eos_token=None)
            for s in specs]


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def private_tokens(reqs: list, bs: int) -> List[int]:
    """Per row, the prompt tokens after the longest block-aligned prefix it
    shares with another row of the traffic: the least prefill work and KV
    that the row can cost, whatever the prefix cache holds."""
    chains = [_block_chain(r.tokens, bs) for r in reqs]
    seen = Counter(k for ch in chains for k in ch)
    out = []
    for r, ch in zip(reqs, chains):
        shared = next((i for i, k in enumerate(ch) if seen[k] < 2), len(ch))
        out.append(max(1, r.num_prompt_tokens - shared * bs))
    return out


def most_rows(costs: Sequence[int], budget: int) -> int:
    """How many of ``costs`` fit one ``budget`` at most (at least one)."""
    rows, total = 0, 0
    for c in sorted(costs):
        if rows and total + c > budget:
            break
        rows, total = rows + 1, total + c
    return rows


def pool_blocks(rqs: list, limits, bs: int) -> int:
    """KV blocks that hold the scheduler's cap of tokens plus one block of
    rounding for every row the cap can hold at once (each row charged at
    least its private prompt tokens and its output limit)."""
    reqs = [r for rq in rqs for r in rq.requests]
    need = [u + r.max_output_tokens for u, r in zip(private_tokens(reqs, bs), reqs)]
    return -(-limits.cap // bs) + most_rows(need, limits.cap)


def shape_buckets(ex, rqs: list, limits) -> Tuple[list, list]:
    """The (batch, length) prefill and (batch, blocks) decode buckets the
    traffic ``rqs`` can reach.

    Prefill: each row's length bucket (the executor's own rule) at every
    power-of-two batch up to the most rows of that bucket one prefill can
    hold: the scheduler fills a prefill up to ``max_num_batched_tokens`` of
    uncached prompt tokens and ``max_num_seqs`` rows, and a row is never
    cheaper than its private tokens (``private_tokens``). Decode: every
    power-of-two batch up to the sequence limit at each table width the
    rows' contexts span."""
    reqs = [r for rq in rqs for r in rq.requests]
    bs = ex.block_size
    cheapest: Dict[int, List[int]] = {}
    for r, u in zip(reqs, private_tokens(reqs, bs)):
        cheapest.setdefault(ex._prefill_group_key(r), []).append(u)
    pre = []
    for L, us in sorted(cheapest.items()):
        rows = most_rows(us, limits.max_num_batched_tokens)
        pre += [(b, L) for b in _pows(_pow2(min(rows, limits.max_num_seqs)))]
    lo = -(-(min(r.num_prompt_tokens for r in reqs) + 1) // bs)
    hi = -(-max(r.num_prompt_tokens + r.max_output_tokens - 1
                for r in reqs) // bs)
    widths = sorted({max(min(_pow2(w), ex.max_blocks_per_seq), w)
                     for w in range(lo, hi + 1)})
    dec = [(b, nb) for b in _pows(_pow2(limits.max_num_seqs)) for nb in widths]
    return pre, dec


def _block_chain(tokens: Sequence[int], bs: int) -> List[int]:
    """One key per full block of ``tokens``, each naming the whole prefix
    up to it."""
    out, key = [], 0
    for i in range(len(tokens) // bs):
        key = hash((key, tuple(tokens[i * bs:(i + 1) * bs])))
        out.append(key)
    return out


def _pows(top: int) -> List[int]:
    return [1 << i for i in range(top.bit_length()) if (1 << i) <= top]


def precapture(ex, pre: list, dec: list) -> None:
    """Capture each bucket's step the executor has not (on the CPU: make
    its eager step), the largest first, handing the memory each capture's
    warm-up left cached back to the device before the next."""
    for key in sorted(pre, key=lambda k: -k[0] * k[1]):
        if key not in ex._prefill_fn:
            ex._prefill_fn[key], _ = ex._prefill_step(*key)
            _release(ex.device)
    for key in sorted(dec, key=lambda k: -k[0] * k[1]):
        if key not in ex._decode_fn:
            ex._decode_fn[key], _ = ex._decode_step(*key)
            _release(ex.device)


def _release(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ records
@dataclass
class Row:
    req: object               # the port's Request
    due: float
    window: bool              # its relQuery is due in the window
    first: Optional[float] = None
    finish: Optional[float] = None
    served: int = 0


@dataclass
class BatchRecord:
    start: float
    end: float
    prefill_lens: List[int]
    decode_ctx: List[int]


@dataclass
class Run:
    """What a run saw; the per-layer metrics' readers take it."""
    mix: dict
    dims: Dict[str, int]
    seconds: float
    setup_s: float = 0.0
    t0: float = 0.0                        # window start, run clock
    t1: float = 0.0                        # window end
    rows: Dict[str, Row] = field(default_factory=dict)
    batches: List[BatchRecord] = field(default_factory=list)
    prefill_samples: List[Tuple[int, float]] = field(default_factory=list)
    decode_samples: List[Tuple[int, float]] = field(default_factory=list)
    schedule_s: float = 0.0                # the window's scheduler seconds
    prefix_hits: int = 0                   # the window's prefix lookups
    prefix_lookups: int = 0
    capture_setup_s: float = 0.0
    window_steps: int = 0                  # steps (graphs) made in the window
    window_capture_s: float = 0.0
    output_tokens: int = 0                 # completed in the window
    lateness: List[float] = field(default_factory=list)
    refused: List[str] = field(default_factory=list)
    end: float = 0.0                       # the drain's end
    preemptions: int = 0
    trace: Optional[dict] = None           # profile.TraceWindow.read()
    trace_span: Tuple[float, float] = (0.0, 0.0)
    trace_start_s: float = 0.0
    trace_stop_s: float = 0.0
    trace_read_s: float = 0.0

    def window_batches(self) -> List[BatchRecord]:
        return [b for b in self.batches if b.start >= self.t0 and b.end <= self.t1]

    def traced_batches(self) -> List[BatchRecord]:
        a, b = self.trace_span
        return [x for x in self.batches if x.start >= a and x.end <= b]


class Recorder:
    """Listens to the engine's batches: each row's first and last token on
    the run's clock, and each batch's rows."""

    def __init__(self, run: Run, clock: Callable[[], float]):
        self.run = run
        self.clock = clock
        self.tick_start = 0.0

    def on_batch(self, event, batch, result) -> None:
        t = self.clock()
        prefill, decode = [], []
        for rid, (_, finished) in result.outputs.items():
            row = self.run.rows.get(rid)
            if row is None:
                continue
            if row.first is None:
                row.first = t
                prefill.append(row.req.num_prompt_tokens)
            else:
                decode.append(row.req.num_prompt_tokens + row.served)
            row.served += 1
            if finished:
                row.finish = t
        self.run.batches.append(BatchRecord(self.tick_start, t, prefill, decode))
        if self.run.t0 <= self.tick_start and t <= self.run.t1:
            self.run.output_tokens += len(result.outputs)


def _spanned(obj, name: str, label: str) -> None:
    """Wrap ``obj.name`` (an instance's method) in a host span."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        with profile.span(label):
            return fn(*a, **kw)

    setattr(obj, name, wrapped)


# ------------------------------------------------------------------ drivers
def serve_all(core, rqs: list, clock) -> None:
    """Admit ``rqs`` at once and serve them to the end (set-up's warm-up)."""
    for rq in rqs:
        rq.arrival_time = clock()
        core.admit(rq, rq.arrival_time)
    while core.tick(clock()) is not None:
        pass


def drive_open_loop(core, rqs: list, run: Run, rec: Recorder, clock,
                    tw: Optional[profile.TraceWindow]) -> None:
    """Admit each relQuery at its due time or right after the tick in
    progress then; after the window, keep admitting and serving until every
    window relQuery has finished or the mix's drain limit has passed."""
    from repro_torch.engine.executor import RequestCapacityError
    window_rqs = [rq for rq in rqs if rq.arrival_time < run.t1]
    drain_end = run.t1 + float(run.mix["drain_s"])
    i = 0
    while True:
        now = clock()
        with profile.span("admit"):
            while i < len(rqs) and rqs[i].arrival_time <= now:
                rq = rqs[i]
                i += 1
                if rq.arrival_time < run.t1:
                    run.lateness.append(now - rq.arrival_time)
                try:
                    core.admit(rq, now)
                except RequestCapacityError:
                    run.refused.append(rq.rel_id)
        if now >= run.t1 and (now >= drain_end or all(
                rq.is_finished() or rq.rel_id in run.refused
                for rq in window_rqs)):
            break
        if tw is not None:
            tw.poll(now)
        rec.tick_start = now
        if core.tick(now) is None:
            nxt = rqs[i].arrival_time if i < len(rqs) else now + 1e-3
            with profile.span("idle"):
                time.sleep(min(max(0.0, nxt - clock()), 2e-3))


def drive_backlog(core, rqs: list, run: Run, rec: Recorder, clock,
                  tw: Optional[profile.TraceWindow]) -> None:
    """Serve the admitted backlog until the window's end (or, tracing,
    until the traced seconds are over)."""
    while True:
        now = clock()
        if now >= run.t1 and not (tw is not None and tw.active):
            break
        if tw is not None:
            tw.poll(now)
        rec.tick_start = now
        if core.tick(now) is None:
            raise RuntimeError("the backlog ran out inside the window: the mix "
                               "offers too little work for this window")


# ------------------------------------------------------------------ the check
def check_sample(run: Run, seed: int) -> List[Row]:
    """The finished rows to check, drawn from the seed: the longest (most
    served tokens, then the longest prompt) first, then rows at random
    until the sample holds the mix's ``check_tokens`` served tokens or
    ``check_rows_max`` rows."""
    if run.mix["driver"] == "open_loop":
        done = [r for r in run.rows.values() if r.window and r.finish is not None]
    else:
        done = [r for r in run.rows.values()
                if r.finish is not None and r.finish <= run.t1]
    if not done:
        return []
    done.sort(key=lambda r: (r.served, r.req.num_prompt_tokens, r.req.req_id),
              reverse=True)
    rest = done[1:]
    random.Random(zlib.crc32(f"check:{seed}".encode())).shuffle(rest)
    out, tokens = [done[0]], done[0].served
    for r in rest:
        if tokens >= run.mix["check_tokens"] or len(out) >= run.mix["check_rows_max"]:
            break
        out.append(r)
        tokens += r.served
    return out


def reference_logits(cfg: dict, params: dict, sample: List[dict],
                     quant: Optional[str] = None) -> List[torch.Tensor]:
    """The reference's logits at each sampled row's served positions, the
    rows run in passes of at most ``REFERENCE_TOKENS`` tokens. ``sample``:
    dicts of ``prompt`` and ``served`` token lists."""
    ref = Reference(cfg, params, quant=quant)
    out: List[torch.Tensor] = []
    i = 0
    while i < len(sample):
        j, tokens = i, 0
        while j < len(sample) and (j == i or tokens + _fed(sample[j]) <= REFERENCE_TOKENS):
            tokens += _fed(sample[j])
            j += 1
        part = sample[i:j]
        out += ref.logits([s["prompt"] + s["served"][:-1] for s in part],
                          [served_positions(len(s["prompt"]), len(s["served"]))
                           for s in part])
        i = j
    return out


def reference_gaps(cfg: dict, params: dict, sample: List[dict]) -> List[float]:
    """Each sampled row's widest served-token gap (``reference/model.py``)."""
    return [served_gap(lg, s["served"])
            for s, lg in zip(sample, reference_logits(cfg, params, sample))]


def _fed(s: dict) -> int:
    return len(s["prompt"]) + len(s["served"]) - 1


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ a run
@dataclass
class Outcome:
    line: dict                 # the result's last line
    run: Run


@dataclass
class Served:
    """The program under test, set up for one cell and seed."""
    params: dict
    engine: object
    blocks: int                # KV pool blocks
    pre: list                  # captured prefill buckets
    dec: list                  # captured decode buckets
    marks: List[Tuple[str, float]]
    nvcc_s: float = 0.0        # the kernels' build (a checkout's first run)


def set_up(cfg: dict, mix: dict, seed: int, traffic: list, device,
           clock: Callable[[], float]) -> Served:
    """Weights from ``seed``, the engine with its pool sized for
    ``traffic`` (the port's relQueries of the window and the warm-up), one
    graph per bucket that traffic can reach, and the warm-up serve of the
    relQueries whose ids start with ``warmup``."""
    marks = [("traffic", clock())]
    nvcc_s = 0.0
    if torch.device(device).type == "cuda":
        # the program's CUDA kernels: nvcc runs in a checkout's first run
        # only (``setup_s`` holds it there); later runs find them built
        from repro_torch.kernels import build
        built = build.build(KERNELS).values()     # one nvcc each, in parallel
        marks.append(("kernels", clock()))
        if any(b.seconds > 0 for b in built):
            nvcc_s = marks[-1][1] - marks[-2][1]
    params = weights.make(cfg, seed, device)
    marks.append(("weights", clock()))
    limits = limits_of(cfg)
    blocks = pool_blocks(traffic, limits, cfg["serving"]["block_size"])
    engine = build_engine(cfg, params, device, blocks)
    marks.append(("engine", clock()))
    pre, dec = shape_buckets(engine.executor, traffic, limits)
    precapture(engine.executor, pre, dec)
    marks.append(("captures", clock()))
    serve_all(engine.core, [rq for rq in traffic if rq.rel_id.startswith("warmup")],
              clock)
    marks.append(("warm-up serve", clock()))
    return Served(params, engine, blocks, pre, dec, marks, nvcc_s)


def serve_window(served: Served, rqs: list, specs: list, mix: dict,
                 run: Run, clock: Callable[[], float],
                 tw_length: float = 0.0) -> None:
    """Drive ``rqs`` (``specs``' relQueries) through the window by the mix's
    driver and fill ``run``; with ``tw_length`` profile the window's last
    ``tw_length`` seconds."""
    core, ex = served.engine.core, served.engine.executor
    run.capture_setup_s = ex.capture_s
    steps0 = len(ex._steps())
    rec = Recorder(run, clock)
    core.on_batch = rec.on_batch
    for rq in rqs:
        for r in rq.requests:
            run.rows[r.req_id] = Row(r, 0.0, False)
    pc = core.scheduler.prefix_cache
    if mix["driver"] == "backlog":
        now = clock()
        for rq in rqs:
            rq.arrival_time = now
            core.admit(rq, now)
    run.t0 = clock()
    run.t1 = run.t0 + run.seconds
    if mix["driver"] == "open_loop":
        for rq, s in zip(rqs, specs):
            rq.arrival_time = run.t0 + s.due
    for rq in rqs:
        for r in rq.requests:
            row = run.rows[r.req_id]
            row.due, row.window = rq.arrival_time, rq.arrival_time < run.t1
    tw = None
    if tw_length:
        tw = profile.TraceWindow(run.t1 - tw_length, tw_length, ex.device)
    n_pre, n_dec = len(ex.prefill_samples), len(ex.decode_samples)
    sched0, hits0, look0 = core.schedule_time, pc.hits, pc.hits + pc.misses
    drive = drive_open_loop if mix["driver"] == "open_loop" else drive_backlog
    drive(core, rqs, run, rec, clock, tw)
    run.end = clock()
    in_window = run.window_batches()
    # the executor adds one sample per batch with a prefill (a decode), in
    # order: the window's batches come first
    run.prefill_samples = ex.prefill_samples[n_pre:n_pre + sum(
        1 for b in in_window if b.prefill_lens)]
    run.decode_samples = ex.decode_samples[n_dec:n_dec + sum(
        1 for b in in_window if b.decode_ctx)]
    run.schedule_s = core.schedule_time - sched0
    run.prefix_hits = pc.hits - hits0
    run.prefix_lookups = pc.hits + pc.misses - look0
    run.window_steps = len(ex._steps()) - steps0
    run.window_capture_s = ex.capture_s - run.capture_setup_s
    run.preemptions = core.scheduler.preemptions
    if tw is not None:
        t_read = time.perf_counter()
        run.trace = tw.read()
        run.trace_read_s = time.perf_counter() - t_read
        run.trace_start_s, run.trace_stop_s = tw.start_s, tw.stop_s
        if run.trace is not None:
            perf0 = time.perf_counter() - clock()
            run.trace_span = (tw.t0 - perf0, tw.t1 - perf0)


def sample_of(run: Run, seed: int) -> List[dict]:
    """The rows ``check_sample`` draws, as plain token lists."""
    return [{"prompt": list(r.req.tokens), "served": list(r.req.output_tokens),
             "limit": r.req.max_output_tokens} for r in check_sample(run, seed)]


def free(served: Served) -> dict:
    """Drop the program's state (engine, pools, graphs), keep the weights."""
    params = served.params
    served.engine = None
    gc.collect()
    if params["embed"].device.type == "cuda":
        torch.cuda.empty_cache()
    return params


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             clock: Callable[[], float], log=print,
             fault: Optional[Callable] = None) -> Outcome:
    """Set up, drive the window, check, and assemble the result line.
    ``clock()`` is the run's clock in seconds since the process started.
    ``fault`` (tests only) is called with the engine before the window, to
    break the timed path underneath."""
    cfg, mix = cell.config, cell.mix
    run = Run(mix, weights.dims(cfg), seconds)
    t_start = clock()
    specs = gen.build(mix, seed, seconds)
    warm_specs = gen.build(mix, seed, seconds, stream="warmup",
                           count=int(mix["warmup_relqueries"]))
    rqs = relqueries(specs)
    served = set_up(cfg, mix, seed, rqs + relqueries(warm_specs), device, clock)
    if trace:
        core, ex = served.engine.core, served.engine.executor
        for obj, name, label in ((core, "_schedule", "schedule"),
                                 (ex, "dispatch", "dispatch"),
                                 (ex, "wait", "wait"),
                                 (core, "_apply_swaps", "swaps")):
            _spanned(obj, name, label)
        profile.warm(device)
    if fault is not None:
        fault(served.engine)
    serve_window(served, rqs, specs, mix, run, clock,
                 min(TRACE_SECONDS, 0.25 * seconds) if trace else 0.0)
    run.setup_s = run.t0          # a backlog's admission is set-up too
    on_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    marks = [("start", t_start)] + served.marks
    log("[relbench] set-up: " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in enumerate(marks[1:])),
        file=sys.stderr)
    longest = max(run.window_batches(), key=lambda b: b.end - b.start, default=None)
    if longest is not None:
        log(f"[relbench] longest tick {longest.end - longest.start:.3f} s: "
            f"{len(longest.prefill_lens)} rows prefilled ({sum(longest.prefill_lens)} "
            f"tokens), {len(longest.decode_ctx)} decoded", file=sys.stderr)
    log(f"[relbench] kernel build: nvcc {served.nvcc_s:.3f} s of setup_s",
        file=sys.stderr)
    log(f"[relbench] setup_s {run.setup_s:.3f} (captures {run.capture_setup_s:.3f} s, "
        f"{len(served.pre)} prefill and {len(served.dec)} decode buckets; "
        f"pool {served.blocks} blocks); steps made in the window {run.window_steps} "
        f"({run.window_capture_s:.3f} s); batches {len(run.window_batches())}; "
        f"preemptions {run.preemptions}; window+drain {run.end - run.t0:.3f} s; "
        f"peak {peak} B", file=sys.stderr)
    if run.lateness:
        log(f"[relbench] generator late: mean {statistics.fmean(run.lateness):.6f} s, "
            f"max {max(run.lateness):.6f} s over {len(run.lateness)} arrivals",
            file=sys.stderr)
    if trace:
        log(f"[relbench] trace: {run.trace_start_s:.3f} s to start, "
            f"{run.trace_stop_s:.3f} s to stop, "
            f"{run.trace_read_s:.3f} s to read", file=sys.stderr)

    # the check, after the program's state is freed
    sample = sample_of(run, seed)
    params = free(served)
    del served, rqs
    t_ref = time.perf_counter()
    gaps = reference_gaps(cfg, params, sample)
    short = sum(len(s["served"]) != s["limit"] for s in sample)
    log(f"[relbench] reference: {len(sample)} rows, "
        f"{sum(len(s['served']) for s in sample)} served tokens, "
        f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limit = float(cfg["check"]["served_logit_gap"])
    checks = {
        "served_logit_gap": {"value": max(gaps) if gaps else None,
                             "limit": limit},
        "rows_short": {"value": short, "limit": 0},
        # a bucket set-up did not reach is captured inside the window
        "window_steps": {"value": run.window_steps, "limit": 0},
    }
    correct = (bool(gaps) and max(gaps) <= limit and short == 0
               and run.window_steps == 0)

    metrics: Dict[str, dict] = {}
    for m in cell.metrics:
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if mix["driver"] == "open_loop":
        # a window relQuery fails if refused or unfinished when the drain ends
        window = [r for r in run.rows.values() if r.window]
        attempted = len({r.req.rel_id for r in window})
        failed = len({r.req.rel_id for r in window if r.finish is None})
    else:
        attempted = len(run.rows)
        failed = len(run.refused)
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {
            "device_ops": _top(run.trace["kernels"]),
            "idle_gaps": _top(run.trace["idle_gaps"])}
    line["checks"] = checks
    return Outcome(line, run)


def _top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
