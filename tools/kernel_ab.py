"""Time the kernels of two checkouts of this repo on one card.

    python3 tools/kernel_ab.py --tree parent=build/parent --tree change=. \
        --order parent,change,change,parent [--out chiprun_out/kernel_ab.json]
    python3 tools/kernel_ab.py ... --rwkv-only --rwkv-shape 1,128,16
    python3 tools/kernel_ab.py ... --swaps-only

Each run is a process of its own: it imports one checkout's ``repro_torch``
(whose kernels build into that checkout's ``build/kernels``) and takes its
inputs, timers and serve trace from this checkout's ``chip_smoke.py``. A run
records, for qwen3-1.7b's attention shapes and ``chip_smoke.ATTN_SHAPES``:

- each kernel's device time (``cuda_time_ms``) and host issue time per call
  (the median of 7 repeats of ``host_issue_ms`` over 50 calls): the
  wrapper's checks, allocations, launches, and in a checkout whose kernels
  load by TMA the encoding of two tensor maps;
- the host time of one ``cuTensorMapEncodeTiled`` call of the driver (median
  of 7 repeats of 1000) at the decode pool's map, the one the paged kernel
  encodes twice per call;
- the wall of qwen3-1.7b's paged serve (serial loop, random weights from
  seed 0, ``chip_smoke.serve_trace``; one warm-up serve, then 2 timed), its
  decode steps, batches and token streams;
- ``rwkv6_chunk``'s device time and host issue per call (r/k/v bf16 at
  rwkv6-7b's 64 heads of 64, o f32) at ``chip_smoke.RWKV_TIME_SHAPES`` and
  each ``--rwkv-shape B,S,chunk``. ``--rwkv-only`` times that and the wall
  of rwkv6-7b's dense serve, the path that calls it (the same serve, one
  warm-up, then 5 timed), and nothing else. Each serve also gives the
  executor's prefill and decode seconds, and there the host seconds spent
  inside its ``rwkv6_chunk`` calls and their count. A checkout whose
  executors replay CUDA graphs calls the wrapper only while it captures a
  bucket, so there those are the captures' calls and seconds.

``--swaps-only`` times the host KV tier's swaps in qwen3-1.7b's paged
executor (full width and depth, bf16, graphed) and nothing else:
``chip_smoke.py``'s planned serve, serial then pipelined, each on an
executor of its own as chip_smoke runs it; then one executor serves
SWAP_REQUESTS prompts of SWAP_PROMPT random tokens (seed 0), SWAP_OUTPUT
tokens out, all arriving at once, at most SWAP_MAX_SEQS decoding, three
times: a first serial serve (its captures and the pinned and device
memory of its first swaps start cold), then a serial and a pipelined one.
Every SWAP_EVERY-th tick the two last running requests are swapped out and
the scheduler swaps them back in, prefetching the next candidate, so the
batches follow from the tick count alone. Each serve records the host
seconds, calls and MB (1e6 bytes) of each swap hook (``chip_smoke.
watch_swaps``); the forced serves also the host seconds of the engine's
``_apply_swaps`` (the ticks' hooks together) per MB, and in the last two
the ticks SWAP_WINDOW under ``torch.profiler``: the wall, the kernels'
busy time (the union of their intervals), and each kind of copy's time
and the part of it that lies under a kernel.

Runs go in the order given, so parent, change, change, parent brackets the
card's drift. Prints each run's record and, last, a JSON object with all of
them and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# --swaps-only's forced-swap serve: ~104 MB of KV a swap at qwen3-1.7b's
# 0.114688 MB a token
SWAP_REQUESTS, SWAP_PROMPT, SWAP_OUTPUT, SWAP_MAX_SEQS = 8, 896, 32, 4
SWAP_EVERY = 3
SWAP_WINDOW = (6, 17)   # first and last tick profiled


def _bind_checkout(src: Path):
    """Import ``repro_torch`` from ``src``, then this checkout's chip_smoke:
    its own ``repro_torch`` imports resolve to the package already bound."""
    sys.path.insert(0, str(src))
    import repro_torch.kernels.ops  # noqa: F401

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    got = Path(cs.ops.__file__).resolve()
    if src.resolve() not in got.parents:
        raise RuntimeError(f"chip_smoke bound {got}, not {src}")
    return cs


def _median_issue(cs, fn) -> float:
    return statistics.median(cs.host_issue_ms(fn, n=50) for _ in range(7))


def _encode_us(pool) -> float:
    """Host microseconds of one cuTensorMapEncodeTiled over ``pool`` [P,
    page, KV, hd] as the paged kernel maps it: (hd, KV, page, P), box (hd,
    1, page, 1), no swizzle."""
    import torch

    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuTensorMapEncodeTiled
    u64p, u32p = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, u64p, u64p, u32p, u32p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    P, page, KV, hd = pool.shape
    es = pool.element_size()
    u64x4, u64x3, u32x4 = (ctypes.c_uint64 * 4, ctypes.c_uint64 * 3,
                           ctypes.c_uint32 * 4)
    dims = u64x4(hd, KV, page, P)
    strides = u64x3(hd * es, KV * hd * es, page * KV * hd * es)
    box, ones = u32x4(hd, 1, page, 1), u32x4(1, 1, 1, 1)
    raw = ctypes.create_string_buffer(128 + 64)   # CUtensorMap: 64-aligned
    addr = ctypes.addressof(raw)
    tmap = ctypes.c_void_p(addr + (-addr) % 64)
    dtype = {torch.bfloat16: 9, torch.float32: 7}[pool.dtype]
    # interleave none, swizzle none, L2 promotion 256B, out-of-bounds fill none
    args = (tmap, dtype, 4, ctypes.c_void_p(pool.data_ptr()), dims, strides,
            box, ones, 0, 0, 3, 0)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cuTensorMapEncodeTiled: CUresult {rc}")
    n, reps = 1000, []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        reps.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(reps)


def _serve(cs, model, params, trace) -> dict:
    import torch
    from repro_torch.serving import build_real_engine

    call, inside = cs.ops.rwkv6_chunk, [0, 0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return call(*args, **kw)
        finally:
            inside[0] += 1
            inside[1] += time.perf_counter() - t0

    arch = model.cfg.name
    backend, max_slots, _ = cs.SERVE[arch]
    engine = build_real_engine(arch, "relserve", backend,
                               model=copy.copy(model), params=params,
                               max_slots=max_slots, max_len=1024,
                               engine_loop="serial", device="cuda")
    trace = copy.deepcopy(trace)
    cs.ops.rwkv6_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_trace(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cs.ops.rwkv6_chunk = call
    ex = engine.executor
    out = {"wall_s": wall, "decode_steps": len(ex.decode_samples),
           "batches": len(ex.decode_samples) + len(ex.prefill_samples),
           "prefill_s": sum(s for _, s in ex.prefill_samples),
           "decode_s": sum(s for _, s in ex.decode_samples),
           "rwkv6_chunk_calls": inside[0], "rwkv6_chunk_host_s": inside[1],
           "streams": [list(r.output_tokens) for rq in trace
                       for r in rq.requests]}
    del engine, ex
    torch.cuda.empty_cache()
    return out


def _rwkv(cs, shapes) -> dict:
    import torch

    out = {}
    for B, S, c in shapes:
        args = cs.rwkv_layer_inputs(torch.bfloat16, B=B, S=S)
        fn = lambda: cs.ops.rwkv6_chunk(*args, out_dtype=torch.float32,  # noqa: E731
                                        chunk=c)
        out[f"B={B} S={S} c={c}"] = {"ms": cs.cuda_time_ms(fn),
                                     "host_issue_ms": _median_issue(cs, fn)}
        del args
    return out


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_window(prof, wall_s: float) -> dict:
    """The kernels' busy ms (their intervals' union) and each kind of
    copy's ms and ms under a kernel, in a profiled window of ``wall_s``."""
    from torch.autograd import DeviceType

    kernels, copies = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy"):
            copies.setdefault(e.name, []).append(span)
        elif not e.name.startswith("Memset"):
            kernels.append(span)
    busy = _union(kernels)
    busy_us = sum(b - a for a, b in busy)
    under = lambda a, b: sum(max(0.0, min(b, d) - max(a, c))  # noqa: E731
                             for c, d in busy)
    return {"wall_ms": wall_s * 1e3, "kernel_busy_ms": busy_us / 1e3,
            "idle": 1 - busy_us / (wall_s * 1e6),
            "copies": {name: {"n": len(spans),
                              "ms": sum(b - a for a, b in spans) / 1e3,
                              "under_kernels_ms": sum(under(a, b)
                                                      for a, b in spans) / 1e3}
                       for name, spans in copies.items()}}


def _forced_swaps(cs, ex, prompts, loop: str, profiled: bool) -> dict:
    """One serve of the forced-swap trace on ``ex`` (module docstring)."""
    import torch
    from repro_torch.core.latency_model import a100_opt13b
    from repro_torch.core.policies import SCHEDULERS
    from repro_torch.core.priority import BatchLimits
    from repro_torch.core.relquery import make_relquery
    from repro_torch.engine.engine import EngineCore
    from torch.profiler import ProfilerActivity, profile

    sched = SCHEDULERS["relserve"](
        limits=BatchLimits(cap=1 << 20, max_num_seqs=SWAP_MAX_SEQS),
        latency_model=a100_opt13b(), kv_admission="optimistic",
        kv_tiering=True, host_kv_cap=1 << 20, swap_prefetch=True)
    core = EngineCore(sched, ex, engine_loop=loop)
    hooks = cs.watch_swaps(ex)
    apply_inner, applied = core._apply_swaps, []

    def apply_swaps(now=0.0):
        t0 = time.perf_counter()
        extra = apply_inner(now)
        applied.append(time.perf_counter() - t0)
        return extra

    core._apply_swaps = apply_swaps
    rq = make_relquery("S", prompts, 0.0, SWAP_OUTPUT)
    core.admit(rq, 0.0)
    prof, window, ticks, now = None, {}, 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while core.has_work():
        if profiled and ticks == SWAP_WINDOW[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            window = {"t0": time.perf_counter(), "graphs": ex.num_graphs}
        now = core.tick(now).end
        ticks += 1
        if prof is not None and ticks == SWAP_WINDOW[1] + 1:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            prof.stop()
        if ticks % SWAP_EVERY == 0 and len(sched._running) >= 2:
            core._flush_plan()
            for r in list(sched._running[-2:]):
                sched.swap_out_request(r, now)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for h in cs.SWAP_HOOKS:
        delattr(ex, h)          # the executor's own hooks again
    mb = sum(st["mb"] for st in hooks.values())
    rec = {"loop": loop, "wall_s": wall, "ticks": ticks,
           "apply_swaps_s": sum(applied), "mb": mb,
           "apply_swaps_ms_per_mb": sum(applied) * 1e3 / mb, "hooks": hooks,
           "streams": [list(r.output_tokens) for r in rq.requests]}
    if prof is not None:
        rec["window"] = dict(_device_window(prof, window["t1"] - window["t0"]),
                             ticks=SWAP_WINDOW[1] - SWAP_WINDOW[0] + 1,
                             captured=ex.num_graphs - window["graphs"])
    return rec


def _swaps(cs) -> dict:
    """--swaps-only: the planned serves, then the forced-swap serves."""
    import numpy as np
    from repro_torch.engine.executor import make_real_executor

    cfg, model, params = cs.full_model("qwen3-1.7b")
    card = cs.nvidia_smi_line()
    trace = cs.serve_trace(cfg.vocab_size - 2, **cs.PLANNED_TRACE)
    serves = []
    for loop in ("serial", "pipelined"):
        got = {}

        def on_engine(engine):
            ex = engine.executor
            if not hasattr(ex, "_copy_fn"):   # copy-on-write not yet a step
                ex._copy_fn = None
            got["hooks"] = cs.watch_swaps(ex)

        streams, _ = cs.run_planned(model, params, trace, loop,
                                    cs.planned_cap(trace), card=card,
                                    on_engine=on_engine)
        serves.append({"loop": f"planned {loop}", "hooks": got["hooks"],
                       "streams": [list(x) for x in streams]})
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size - 2, size=SWAP_PROMPT).tolist()
               for _ in range(SWAP_REQUESTS)]
    blocks = -(-SWAP_REQUESTS * (SWAP_PROMPT + SWAP_OUTPUT) // 16) + 64
    ex = make_real_executor("paged", model, params, max_slots=SWAP_MAX_SEQS,
                            max_len=SWAP_PROMPT + SWAP_OUTPUT + 16,
                            num_blocks=blocks, block_size=16,
                            num_host_blocks=blocks)
    for loop, profiled in (("serial", False), ("serial", True),
                           ("pipelined", True)):
        serves.append(_forced_swaps(cs, ex, prompts, loop, profiled))
    return {"serves": serves}


def _brief_swaps(s: dict) -> str:
    hooks = ", ".join(f"{h} {v['calls']}x {v['mb']:.1f} MB {v['s'] * 1e3:.2f} ms"
                      for h, v in s["hooks"].items() if v["calls"])
    mb = sum(v["mb"] for v in s["hooks"].values())
    sec = sum(v["s"] for v in s["hooks"].values())
    line = f"{s['loop']}: hooks {sec * 1e3 / mb:.5f} ms/MB ({hooks})"
    if "wall_s" in s:
        line += (f"; wall {s['wall_s']:.3f}s, {s['ticks']} ticks, "
                 f"_apply_swaps {s['apply_swaps_ms_per_mb']:.5f} ms/MB")
    w = s.get("window")
    if w:
        copies = "; ".join(f"{k} {v['n']}x {v['ms']:.2f} ms, "
                           f"{v['under_kernels_ms']:.2f} under kernels"
                           for k, v in w["copies"].items())
        line += (f"; window {w['ticks']} ticks: wall {w['wall_ms']:.1f} ms, "
                 f"kernels busy {w['kernel_busy_ms']:.2f} ms, idle "
                 f"{w['idle']:.3f}, {w['captured']} captures; {copies}")
    return line


def worker(src: Path, rwkv_shapes, mode: str) -> dict:
    cs = _bind_checkout(src)
    import torch

    rwkv_shapes = list(dict.fromkeys(cs.RWKV_TIME_SHAPES + rwkv_shapes))

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build()
    if mode == "swaps":
        return dict(_swaps(cs), src=str(src))
    ops, dt = cs.ops, torch.bfloat16
    rec = {"src": str(src), "paged": {}, "prefill": {},
           "rwkv": _rwkv(cs, rwkv_shapes)}
    if mode == "rwkv":
        cfg, model, params = cs.full_model("rwkv6-7b")
        trace = cs.serve_trace(cfg.vocab_size - 2)
        _serve(cs, model, params, trace)   # warm-up: cuBLAS, allocator
        rec["serves"] = [_serve(cs, model, params, trace) for _ in range(5)]
        return rec
    shapes = [("qwen3-1.7b KV 8 Qp 2 hd 128", 8, 2, 128)] + cs.ATTN_SHAPES
    for label, KV, R, hd in shapes:
        args = cs.paged_inputs(dt, KV=KV, Qp=R, hd=hd)
        rec["paged"][label] = {
            "ms": cs.cuda_time_ms(lambda: ops.paged_attention(*args)),
            "host_issue_ms": _median_issue(
                cs, lambda: ops.paged_attention(*args))}
        q, k, v = cs.prefill_inputs(dt, G=KV, R=R, hd=hd)
        rec["prefill"][label] = {
            "ms": cs.cuda_time_ms(
                lambda: ops.flash_prefill(q, k, v, causal=True)),
            "host_issue_ms": _median_issue(
                cs, lambda: ops.flash_prefill(q, k, v, causal=True))}
    rec["encode_us"] = _encode_us(cs.paged_inputs(dt)[1])
    _, model, params = cs.full_model("qwen3-1.7b")
    trace = cs.serve_trace()
    _serve(cs, model, params, trace)   # warm-up: cuBLAS, allocator
    rec["serves"] = [_serve(cs, model, params, trace) for _ in range(2)]
    return rec


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout (repeat)")
    ap.add_argument("--order", help="comma-separated names, in run order")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--rwkv-shape", action="append", default=[],
                    help="B,S,chunk of an rwkv6_chunk call to time (repeat)")
    ap.add_argument("--rwkv-only", action="store_true",
                    help="time rwkv6_chunk and the rwkv6-7b serve only")
    ap.add_argument("--swaps-only", action="store_true",
                    help="time the swap hooks of qwen3-1.7b's serves only")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    mode = "swaps" if a.swaps_only else "rwkv" if a.rwkv_only else "all"
    if a.worker:
        extra = [tuple(int(x) for x in sh.split(",")) for sh in a.rwkv_shape]
        print("RECORD " + json.dumps(worker(Path(a.worker), extra, mode)),
              flush=True)
        return
    trees = dict(t.split("=", 1) for t in a.tree)
    order = a.order.split(",") if a.order else list(trees)
    runs = []
    for name in order:
        src = Path(trees[name]).resolve() / "src"
        t0 = time.perf_counter()
        flags = [f"--rwkv-shape={sh}" for sh in a.rwkv_shape]
        flags += {"swaps": ["--swaps-only"], "rwkv": ["--rwkv-only"],
                  "all": []}[mode]
        res = subprocess.run([sys.executable, __file__, "--worker", str(src),
                              *flags], capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=""))
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            raise SystemExit(f"run {name}: exit {res.returncode}")
        line = [x for x in res.stdout.splitlines() if x.startswith("RECORD ")][-1]
        rec = dict(json.loads(line[len("RECORD "):]), name=name,
                   seconds=time.perf_counter() - t0)
        runs.append(rec)
        if mode == "swaps":
            for s in rec["serves"]:
                print(f"[ab] {name} {_brief_swaps(s)}", flush=True)
            continue
        brief = {k: {s: {m: round(x, 4) for m, x in v.items()}
                     for s, v in rec[k].items()}
                 for k in ("paged", "prefill", "rwkv")}
        walls = ("serve walls / prefill / decode / in rwkv6_chunk s "
                 + str([[round(s[k], 4) for k in ("wall_s", "prefill_s",
                                                  "decode_s",
                                                  "rwkv6_chunk_host_s")]
                        for s in rec["serves"]])
                 + f", {rec['serves'][0]['decode_steps']} decode steps")
        if mode == "rwkv":
            print(f"[ab] {name}: {walls}; {brief['rwkv']}", flush=True)
            continue
        print(f"[ab] {name}: encode {rec['encode_us']:.3f} us; {walls}; "
              f"{brief}", flush=True)
    # token streams of each serve against the first run's same serve (with
    # --swaps-only) or first serve
    for rec in runs:
        for i, s in enumerate(rec["serves"]):
            first = runs[0]["serves"][i if mode == "swaps" else 0]["streams"]
            s["streams_equal_to_first"] = sum(
                x == y for x, y in zip(s["streams"], first)) / len(first)
    out = {"card": smi(), "runs": runs}
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    for rec in runs:
        for s in rec["serves"]:
            del s["streams"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
