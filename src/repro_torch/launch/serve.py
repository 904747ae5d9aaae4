"""Serving entry point of the port: RelServe (or any baseline) over a relQuery
workload on a real PyTorch engine, on CUDA unless ``--device cpu`` is given.

Real mode of ``repro/launch/serve.py``: a smoke-scale model of ``--arch``
with random weights from ``--seed``, one replica, driven closed-loop through
the Frontend shim or, with ``--open-loop``, as a scripted open-loop session
(mid-flight submission, token streaming, cancellation, a live snapshot).
``--simulate``, ``--plan`` and ``--num-replicas > 1`` are not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --kv-backend paged
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --num-relqueries 4
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.latency_model import a100_opt13b
from repro_torch.core.policies import SCHEDULERS
from repro_torch.core.priority import BatchLimits, DPUConfig
from repro_torch.data.datasets import ALL_DATASETS, make_dataset
from repro_torch.data.trace import TraceConfig, build_trace
from repro_torch.serving import Frontend, build_real_engine
from repro_torch.serving.factory import resolve_device
from repro_torch.serving.frontend import RelQueryStatus


def _print_report(tag: str, report) -> None:
    w, c, t = report.phase_means()
    print(f"[{tag}] relqueries={len(report.latencies)}  "
          f"avg {report.avg_latency:.2f}s  p50 {report.percentile(50):.2f}  "
          f"p99 {report.percentile(99):.2f}  max {report.max_latency:.2f}")
    print(f"[{tag}] phases: waiting {w:.2f}s  core {c:.2f}s  tail {t:.2f}s  |  "
          f"e2e {report.end_to_end:.1f}s  prefix-hit {report.prefix_hit_ratio:.2%}  "
          f"iterations {len(report.events)}")
    if report.preemptions:
        print(f"[{tag}] kv-pressure: {report.preemptions} preemptions  "
              f"{report.preempted_tokens} tokens reclaimed")
    if report.shared_kv_tokens:
        print(f"[{tag}] prefix-sharing: {report.shared_kv_tokens} KV cap "
              f"tokens counted once (shared blocks)")
    if report.deduped_requests or report.plan_time:
        print(f"[{tag}] planner: {report.deduped_requests} rows answered by "
              f"dedup fan-out  plan {report.plan_time * 1e3:.2f}ms")
    if report.swap_outs or report.swap_ins:
        print(f"[{tag}] kv-tiering: {report.swap_outs} swap-outs "
              f"({report.swapped_out_tokens} tok)  {report.swap_ins} swap-ins "
              f"({report.swapped_in_tokens} tok)  "
              f"{report.swap_bytes_moved / 1e9:.2f} GB moved  reclaim "
              f"{report.reclaim_swap_decisions} swap / "
              f"{report.reclaim_recompute_decisions} recompute")
    if report.proactive_offloads or report.swap_prefetches:
        print(f"[{tag}] proactive-tiering: {report.proactive_offloads} offloads  "
              f"{report.swap_prefetches} prefetches "
              f"({report.prefetch_hits} zero-stall hits, "
              f"{report.prefetch_cancelled} cancelled)")


def run_open_loop(frontend: Frontend, trace) -> "object":
    """Scripted open-loop session over ``frontend``: replay-style arrivals
    interleaved with engine steps, plus — mid-flight — a token-streaming
    subscription, one cancellation, one interactive late submission and a
    live snapshot. Returns the final merged ServiceReport; asserts the
    invariants CI relies on (KV fully reclaimed, cancellation terminal)."""
    pending = sorted(trace, key=lambda r: r.arrival_time)
    if len(pending) < 4:
        raise SystemExit("--open-loop needs --num-relqueries >= 4")
    late = pending[-1]            # held back, submitted interactively
    pending = pending[:-1]

    streamed = {"tokens": 0}

    def on_token(req_id: str, token: int) -> None:
        streamed["tokens"] += 1

    handles = []
    cancel_handle = None
    late_handle = None
    snapshot_taken = False
    idx = 0
    steps = 0
    while idx < len(pending) or frontend.has_work():
        nxt = frontend.next_step_time()
        if idx < len(pending) and (nxt is None or
                                   pending[idx].arrival_time <= nxt):
            rq = pending[idx]
            idx += 1
            handles.append(frontend.submit(
                rq, now=rq.arrival_time,
                on_token=on_token if len(handles) == 0 else None))
            continue
        frontend.step()
        steps += 1
        if steps >= 5 and cancel_handle is None and len(handles) >= 3:
            live = [h for h in handles[1:]   # keep the streaming handle alive
                    if h.status() in (RelQueryStatus.QUEUED,
                                      RelQueryStatus.RUNNING)]
            if live:
                cancel_handle = live[-1]
                cancel_handle.cancel()
                print(f"[open-loop] cancelled {cancel_handle.rel_id} "
                      f"mid-flight at t={frontend.now:.2f}s")
        if steps >= 8 and late_handle is None and cancel_handle is not None:
            late_handle = frontend.submit(late)   # arrives "now"
            handles.append(late_handle)
            print(f"[open-loop] late-submitted {late.rel_id} "
                  f"at t={late.arrival_time:.2f}s")
        if not snapshot_taken and late_handle is not None and steps >= 12:
            snapshot_taken = True
            snap = frontend.snapshot()
            print(f"[open-loop] mid-flight snapshot: "
                  f"{len(snap.latencies)} finished, "
                  f"{len(snap.cancelled_rel_ids)} cancelled, "
                  f"clock {snap.end_to_end:.2f}s")

    report = frontend.snapshot()
    done = sum(1 for h in handles if h.status() is RelQueryStatus.FINISHED)
    print(f"[open-loop] {done} finished / {len(report.cancelled_rel_ids)} "
          f"cancelled, {streamed['tokens']} tokens streamed on "
          f"{handles[0].rel_id}")
    # invariants the smoke lane pins — strict: if the workload drains before
    # the scripted cancel/late-submit/snapshot fire, the smoke exercised
    # nothing and must fail loudly, not pass vacuously.
    for core in frontend.cores:
        assert core.scheduler.tokens_in_use == 0, "KV tokens leaked"
        assert core.scheduler.committed_tokens == 0, "KV commitment leaked"
    assert cancel_handle is not None, \
        "smoke never cancelled — raise --num-relqueries/--rate"
    assert cancel_handle.status() is RelQueryStatus.CANCELLED
    assert cancel_handle.rel_id not in report.latencies
    assert streamed["tokens"] > 0, "no tokens streamed"
    assert late_handle is not None, "smoke never late-submitted"
    assert late_handle.status() is RelQueryStatus.FINISHED
    assert snapshot_taken, "smoke never took a mid-flight snapshot"
    print("OPEN-LOOP SMOKE OK")
    return report




def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="relserve", choices=list(SCHEDULERS))
    ap.add_argument("--dataset", default="rotten", choices=list(ALL_DATASETS))
    ap.add_argument("--simulate", action="store_true",
                    help="simulated clock (not ported yet)")
    ap.add_argument("--open-loop", action="store_true",
                    help="scripted open-loop Frontend session (submit/stream/"
                         "cancel/snapshot) instead of closed-loop replay")
    ap.add_argument("--plan", default="off",
                    help="workload planner (not ported yet; only 'off')")
    ap.add_argument("--dup-row-fraction", type=float, default=0.0,
                    help="fraction of each relQuery's rows replaced by exact "
                         "copies of earlier rows")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--num-relqueries", type=int, default=100)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--max-requests", type=int, default=100)
    ap.add_argument("--num-replicas", type=int, default=1,
                    help="engine replicas (only 1 is ported)")
    ap.add_argument("--kv-backend", default="dense", choices=["dense", "paged"],
                    help="'dense' per-slot caches or 'paged' — a "
                         "BlockManager-owned block pool with per-request "
                         "block tables, batched bucketed prefill (flash_prefill "
                         "kernel on CUDA) and paged-attention decode "
                         "(paged_attention kernel on CUDA); on the CPU token "
                         "streams are bit-identical across backends")
    ap.add_argument("--kv-admission", default="conservative",
                    choices=["conservative", "optimistic", "predicted"],
                    help="KV-cap admission policy: 'conservative' reserves "
                         "each request's worst-case footprint upfront; "
                         "'optimistic' admits on current footprint and "
                         "preempts on cap pressure; 'predicted' admits on the "
                         "per-template predicted output length")
    ap.add_argument("--kv-cap", type=int, default=None,
                    help="override the KV-resident token cap (BatchLimits.cap)")
    ap.add_argument("--kv-tiering", default="off", choices=["on", "off"],
                    help="host-offload KV tier under cap pressure (requires a "
                         "preempting --kv-admission)")
    ap.add_argument("--host-kv-cap", type=int, default=None,
                    help="host-tier capacity in KV tokens (with --kv-tiering "
                         "on; default 4x the device cap)")
    ap.add_argument("--swap-bandwidth", type=float, default=None,
                    help="modeled device<->host bandwidth in GB/s for the "
                         "swap cost model (with --kv-tiering on; default 32)")
    ap.add_argument("--proactive-offload", default="off", choices=["on", "off"],
                    help="proactive idle-tail KV offload (with --kv-tiering on)")
    ap.add_argument("--idle-horizon", type=float, default=None,
                    help="predicted-remaining-work threshold in seconds for "
                         "proactive offload (default 1.0)")
    ap.add_argument("--swap-prefetch", default="off", choices=["on", "off"],
                    help="swap-in prefetch one tick early (with --kv-tiering on)")
    ap.add_argument("--debug-invariants", action="store_true",
                    help="assert scheduler-ledger / block-pool invariants "
                         "after every tick (slow)")
    ap.add_argument("--prefix-sharing", default="off", choices=["on", "off"],
                    help="prefix-sharing-aware scheduling and physically "
                         "shared prefix blocks")
    ap.add_argument("--dpu-exact-probe", action="store_true",
                    help="DPU prices priorities with a full prefix-cache probe")
    ap.add_argument("--engine-loop", default="serial",
                    choices=["serial", "pipelined"],
                    help="'serial' schedules then executes; 'pipelined' "
                         "schedules the next batch while the current one runs "
                         "on the device — token streams are bit-identical")
    ap.add_argument("--starvation-threshold", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.simulate:
        raise SystemExit("--simulate is not ported to repro_torch yet; use "
                         "python -m repro.launch.serve --simulate")
    if args.plan != "off":
        raise SystemExit("--plan is not ported to repro_torch yet")
    if args.num_replicas != 1:
        raise SystemExit("--num-replicas > 1 is not ported to repro_torch yet")
    if args.rate <= 0:
        raise SystemExit(f"--rate must be > 0 relQueries/s (got {args.rate})")
    if args.num_relqueries < 1:
        raise SystemExit(
            f"--num-relqueries must be >= 1 (got {args.num_relqueries})")
    if args.max_requests < 1:
        raise SystemExit(f"--max-requests must be >= 1 (got {args.max_requests})")
    if args.kv_cap is not None and args.kv_cap < 1:
        raise SystemExit(f"--kv-cap must be >= 1 (got {args.kv_cap})")
    if not 0.0 <= args.dup_row_fraction <= 1.0:
        raise SystemExit(f"--dup-row-fraction must be in [0, 1] "
                         f"(got {args.dup_row_fraction})")
    kv_tiering = args.kv_tiering == "on"
    if kv_tiering and args.kv_admission == "conservative":
        raise SystemExit("--kv-tiering on requires a preempting admission "
                         "mode; pass --kv-admission optimistic or predicted")
    if not kv_tiering and args.host_kv_cap is not None:
        raise SystemExit("--host-kv-cap only applies with --kv-tiering on")
    if not kv_tiering and args.swap_bandwidth is not None:
        raise SystemExit("--swap-bandwidth only applies with --kv-tiering on")
    if args.host_kv_cap is not None and args.host_kv_cap < 1:
        raise SystemExit(f"--host-kv-cap must be >= 1 (got {args.host_kv_cap})")
    if args.swap_bandwidth is not None and args.swap_bandwidth <= 0:
        raise SystemExit(f"--swap-bandwidth must be > 0 GB/s "
                         f"(got {args.swap_bandwidth})")
    proactive_offload = args.proactive_offload == "on"
    swap_prefetch = args.swap_prefetch == "on"
    if proactive_offload and not kv_tiering:
        raise SystemExit("--proactive-offload only applies with "
                         "--kv-tiering on")
    if swap_prefetch and not kv_tiering:
        raise SystemExit("--swap-prefetch only applies with --kv-tiering on")
    if args.idle_horizon is not None and not proactive_offload:
        raise SystemExit("--idle-horizon only applies with "
                         "--proactive-offload on")
    if args.idle_horizon is not None and args.idle_horizon <= 0:
        raise SystemExit(f"--idle-horizon must be > 0 s "
                         f"(got {args.idle_horizon})")

    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    lm = a100_opt13b()
    limits = BatchLimits() if args.kv_cap is None else BatchLimits(cap=args.kv_cap)
    host_kv_cap = args.host_kv_cap if args.host_kv_cap is not None \
        else 4 * limits.cap
    swap_bandwidth = args.swap_bandwidth if args.swap_bandwidth is not None \
        else 32.0
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    ds = make_dataset(args.dataset, num_rows=1000, seed=args.seed)
    # output_token_cap keeps decoding short without mutating the built trace
    trace = build_trace(ds, TraceConfig(
        num_relqueries=min(args.num_relqueries, 8), rate=args.rate,
        seed=args.seed, max_requests=min(args.max_requests, 8),
        output_token_cap=8,
        dup_row_fraction=args.dup_row_fraction), tokenizer=tok)
    try:
        engine = build_real_engine(
            args.arch, args.scheduler, args.kv_backend, limits=limits,
            latency_model=lm, kv_admission=args.kv_admission,
            prefix_sharing=args.prefix_sharing == "on", max_slots=64,
            max_len=1024, model=model, params=params,
            engine_loop=args.engine_loop,
            dpu_config=DPUConfig(
                starvation_threshold=args.starvation_threshold,
                exact_probe=args.dpu_exact_probe)
            if args.scheduler.startswith("relserve") else None,
            kv_tiering=kv_tiering,
            host_kv_cap=host_kv_cap if kv_tiering else 0,
            swap_bandwidth_gbps=swap_bandwidth,
            proactive_offload=proactive_offload,
            idle_horizon_s=args.idle_horizon, swap_prefetch=swap_prefetch,
            debug_invariants=args.debug_invariants, device=device)
    except NotImplementedError as e:
        raise SystemExit(f"--kv-backend {args.kv_backend}: {e}")
    print(f"scheduler={args.scheduler} kv-backend={args.kv_backend} "
          f"engine-loop={args.engine_loop} kv-tiering={args.kv_tiering} "
          f"device={device}")
    if args.open_loop:
        report = run_open_loop(Frontend(engine), trace)
        _print_report("open-loop", report)
    else:
        report = engine.run_trace(trace)
        _print_report("merged", report)

    print(f"overheads: DPU {report.dpu_time:.3f}s  ABA {report.aba_time:.3f}s  "
          f"schedule {report.schedule_time:.3f}s  "
          f"retry {report.schedule_retry_time:.3f}s "
          f"({report.schedule_retries} retries)")
    if report.overlap_hidden_time:
        print(f"overlap: {report.overlap_hidden_time:.3f}s of scheduler work "
              f"hidden behind device compute (pipelined loop)")


if __name__ == "__main__":
    main()
