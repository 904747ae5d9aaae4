"""Serving entry point of the port: RelServe (or any baseline) over a
relQuery workload.

Two execution modes, as in ``repro/launch/serve.py``:
  --simulate      paper-scale traces on the simulated clock (the default
                  latency model is the paper's OPT-13B/A100 regime, so every
                  latency it prints is simulated, not measured); supports
                  --num-replicas N data-parallel engine replicas behind the
                  relQuery-affine router, --crash-at fault injection with
                  snapshot failover, and --autoscale. It builds no model and
                  touches no torch device, so it refuses --device.
  (default)       a real PyTorch engine on a smoke-scale model of ``--arch``
                  with random weights from ``--seed``, one replica, on CUDA
                  unless ``--device cpu`` is given. The full-attention
                  archs (qwen3-1.7b, qwen2-0.5b, qwen2.5-32b, the
                  internvl2-26b backbone, granite-moe-3b-a800m,
                  qwen3-moe-30b-a3b) take either KV backend; gemma3-12b
                  (window layers), rwkv6-7b and hymba-1.5b the dense
                  backend only (``--kv-backend paged`` exits, as the
                  reference refuses it). whisper-base has no engine path
                  and exits.

and two drive modes:
  (default)       closed-loop trace replay through the Frontend shim
  --open-loop     scripted open-loop session on the Frontend: mid-flight
                  submission, token streaming, cancellation and a live
                  snapshot — the smoke test for the serving API

Closed-loop replay optionally routes through the workload planner
(``--plan off|dedup|reorder|full``): exact-duplicate rows are answered once
and fanned out, rows are reordered into prefix-maximizing order, and the
report gains logical-vs-physical accounting — with per-row outputs
bit-identical to the unplanned replay.

  PYTHONPATH=src python -m repro_torch.launch.serve --simulate --scheduler relserve
  PYTHONPATH=src python -m repro_torch.launch.serve --simulate --num-replicas 4
  PYTHONPATH=src python -m repro_torch.launch.serve --simulate --plan full \
      --dup-row-fraction 0.5 --prefix-sharing on
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-backend paged
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --plan full \
      --kv-backend paged --dup-row-fraction 0.5 --num-relqueries 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --kv-backend paged --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.latency_model import a100_opt13b
from repro_torch.core.policies import SCHEDULERS
from repro_torch.core.priority import BatchLimits, DPUConfig
from repro_torch.data.datasets import ALL_DATASETS, make_dataset
from repro_torch.data.trace import TraceConfig, build_trace
from repro_torch.planner import PLAN_MODES, PlanExecutor, Planner
from repro_torch.serving import (ROUTER_POLICIES, AutoscaleConfig, Autoscaler,
                           Frontend, build_simulated_cluster)
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


def run_planned(frontend: Frontend, trace, mode: str, tokenizer=None):
    """Closed-loop replay through the workload planner: rewrite the trace
    (dedup / prefix-maximizing reorder per --plan), submit the physical
    relQueries through the Frontend, fan answers back out to every logical
    row. Per-row outputs are bit-identical to the unplanned replay."""
    planner = Planner(mode, tokenizer=tokenizer)
    executor = PlanExecutor(frontend, planner)
    planned = planner.plan_trace(trace)
    n_logical = sum(p.num_logical for p in planned)
    n_physical = sum(p.num_physical for p in planned)
    print(f"planner: mode={mode}  {n_logical} logical requests -> "
          f"{n_physical} physical ({n_logical - n_physical} deduped)")
    return executor.replay(planned)


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


def run_elastic_replay(frontend: Frontend, cluster, trace,
                       crash_at: "float | None" = None,
                       metrics_log: "str | None" = None,
                       metrics_interval: float = 5.0,
                       max_iterations: int = 2_000_000):
    """Closed-loop replay with the elastic controls live: deterministic
    replica-crash injection at ``--crash-at`` (the busiest admitting replica
    dies; its in-flight relQueries fail over to the survivors), autoscaler
    ticks (attached on the cluster), and periodic ``metrics_snapshot``
    samples written as JSONL to ``--metrics-log``."""
    import json
    import math
    import os

    pending = sorted(trace, key=lambda r: r.arrival_time)
    idx = 0
    it = 0
    crash_done = crash_at is None
    samples = []
    next_sample = 0.0
    while True:
        f = frontend.next_step_time()
        next_step = math.inf if f is None else f
        next_arrival = (pending[idx].arrival_time if idx < len(pending)
                        else math.inf)
        if not crash_done and min(next_step, next_arrival) >= crash_at:
            admitting = cluster.admitting_replicas()
            victim = max(admitting,
                         key=lambda i: (cluster.cores[i].load(), -i))
            event = cluster.crash_replica(victim, crash_at)
            print(f"[fault] crashed replica {victim} at t={crash_at:.2f}s: "
                  f"{event['victims']} relQueries failed over "
                  f"({event['from_snapshot']} from snapshot, "
                  f"{event['tokens_preserved']} tokens preserved, "
                  f"{event['tokens_lost']} lost -> recomputed)")
            crash_done = True
            continue
        if math.isinf(next_step) and math.isinf(next_arrival):
            break
        if next_arrival <= next_step:
            frontend.submit(pending[idx], now=next_arrival)
            idx += 1
        else:
            frontend.step()
            it += 1
            if it >= max_iterations:
                raise RuntimeError(
                    "elastic replay exceeded max_iterations — likely livelock")
        if metrics_log is not None and frontend.clock >= next_sample:
            samples.append(cluster.metrics_snapshot(frontend.clock))
            next_sample = frontend.clock + metrics_interval
    if not crash_done:
        print(f"[fault] warning: workload drained before --crash-at "
              f"{crash_at}s — no crash was injected")
    if metrics_log is not None:
        samples.append(cluster.metrics_snapshot(frontend.clock))
        parent = os.path.dirname(metrics_log)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(metrics_log, "w") as fh:
            for s in samples:
                fh.write(json.dumps(s) + "\n")
        print(f"[metrics] wrote {len(samples)} samples to {metrics_log}")
    return cluster.report()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="relserve", choices=list(SCHEDULERS))
    ap.add_argument("--dataset", default="rotten", choices=list(ALL_DATASETS))
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--open-loop", action="store_true",
                    help="scripted open-loop Frontend session (submit/stream/"
                         "cancel/snapshot) instead of closed-loop replay")
    ap.add_argument("--plan", default="off", choices=list(PLAN_MODES),
                    help="workload planner in front of the scheduler: 'dedup' "
                         "answers each exact-duplicate row once and fans the "
                         "stream out; 'reorder' sorts rows into prefix-"
                         "maximizing order; 'full' runs both. Per-row outputs "
                         "stay bit-identical to 'off'")
    ap.add_argument("--dup-row-fraction", type=float, default=0.0,
                    help="fraction of each relQuery's rows replaced by exact "
                         "copies of earlier rows (duplicate-heavy regime the "
                         "planner's dedup pass targets); 0.0 is byte-"
                         "identical to historical traces")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--num-relqueries", type=int, default=100)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--max-requests", type=int, default=100)
    ap.add_argument("--num-replicas", type=int, default=1,
                    help="data-parallel engine replicas (simulate mode)")
    ap.add_argument("--router", default="affinity_spill",
                    choices=list(ROUTER_POLICIES))
    ap.add_argument("--kv-backend", default="dense", choices=["dense", "paged"],
                    help="real-mode KV layout: 'dense' per-slot caches "
                         "(max_slots x max_len buffers) or 'paged' — a "
                         "BlockManager-owned block pool with per-request "
                         "block tables, batched bucketed prefill "
                         "(flash_prefill kernel on CUDA) and paged-attention "
                         "decode (paged_attention kernel on CUDA); on the CPU "
                         "token streams are bit-identical across backends")
    ap.add_argument("--kv-admission", default="conservative",
                    choices=["conservative", "optimistic", "predicted"],
                    help="KV-cap admission policy: 'conservative' reserves "
                         "each request's worst-case prompt+output footprint "
                         "upfront; 'optimistic' admits on current footprint "
                         "and preempts the lowest-priority running relQuery "
                         "(re-prefill restart) when decode growth hits the "
                         "cap; 'predicted' admits on the per-template "
                         "predicted output length (ALISE-style quantile of "
                         "finished siblings; worst case until history "
                         "accumulates) with preemption as the safety valve")
    ap.add_argument("--kv-cap", type=int, default=None,
                    help="override the KV-resident token cap (BatchLimits.cap)")
    ap.add_argument("--kv-tiering", default="off", choices=["on", "off"],
                    help="host-offload KV tier: under cap pressure a victim's "
                         "KV is swapped to host memory (and back, resuming "
                         "decode without re-prefill) whenever the modeled "
                         "transfer beats re-prefilling it — per-victim "
                         "cost-based reclaim; 'off' is bit-identical "
                         "recompute-only preemption. Requires a preempting "
                         "--kv-admission (optimistic or predicted)")
    ap.add_argument("--host-kv-cap", type=int, default=None,
                    help="host-tier capacity in KV tokens (with --kv-tiering "
                         "on; default 4x the device cap)")
    ap.add_argument("--swap-bandwidth", type=float, default=None,
                    help="modeled device<->host link bandwidth in GB/s for "
                         "the swap cost model (with --kv-tiering on; "
                         "default 32). Concurrent swaps in one tick queue "
                         "against this shared budget")
    ap.add_argument("--proactive-offload", default="off",
                    choices=["on", "off"],
                    help="FastServe-style proactive KV offload (with "
                         "--kv-tiering on): each tick, idle-tail victims — "
                         "requests of parked relQueries, stragglers past the "
                         "decode batch width, and (under pre-pressure) "
                         "requests whose predicted remaining work exceeds "
                         "--idle-horizon — are swapped to the host tier "
                         "before the pressure valve is forced to act. "
                         "Timing-only: token streams are bit-identical "
                         "on vs off")
    ap.add_argument("--idle-horizon", type=float, default=None,
                    help="predicted-remaining-work threshold in seconds for "
                         "the proactive-offload idle-tail victim class (with "
                         "--proactive-offload on; default 1.0)")
    ap.add_argument("--swap-prefetch", default="off", choices=["on", "off"],
                    help="ALISE-style swap-in prefetch (with --kv-tiering "
                         "on): the next resume candidate's host->device copy "
                         "is issued a tick early and rides under compute, so "
                         "the resume commits with zero stall. Timing-only: "
                         "token streams are bit-identical on vs off")
    ap.add_argument("--debug-invariants", action="store_true",
                    help="assert scheduler-ledger / block-pool / shared-"
                         "ledger invariants after every tick (slow; CI smoke)")
    ap.add_argument("--prefix-sharing", default="off", choices=["on", "off"],
                    help="prefix-sharing-aware scheduling: warm-then-follow "
                         "prefill candidates and shared-block KV admission "
                         "(shared template prefixes count once against the "
                         "cap); 'off' is bit-identical to the pre-sharing "
                         "scheduler")
    ap.add_argument("--dpu-exact-probe", action="store_true",
                    help="DPU prices priorities with a full prefix-cache "
                         "probe (realized sharing) instead of Eq. 11's "
                         "sampled miss ratio")
    ap.add_argument("--engine-loop", default="serial",
                    choices=["serial", "pipelined"],
                    help="engine tick loop: 'serial' schedules then executes; "
                         "'pipelined' splits the executor into dispatch/wait "
                         "and schedules the next batch against a projected "
                         "ledger while the current one runs on device — token "
                         "streams and simulated-clock reports are "
                         "bit-identical either way")
    ap.add_argument("--starvation-threshold", type=float, default=None)
    ap.add_argument("--autoscale", action="store_true",
                    help="attach the queue-depth/p50 autoscaler: replicas are "
                         "added under backlog and gracefully drained (migrate "
                         "waiting relQueries, finish resident work, retire) "
                         "when idle, between --min-replicas and "
                         "--max-replicas (simulate, closed-loop)")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscaler floor (default 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscaler ceiling (default max(4, 2x "
                         "--num-replicas))")
    ap.add_argument("--crash-at", type=float, default=None,
                    help="deterministic fault injection: kill the busiest "
                         "admitting replica at this simulated time; its "
                         "in-flight relQueries fail over to the survivors "
                         "(rewound to the last periodic snapshot when one "
                         "exists) with final streams bit-identical to a "
                         "crash-free run (simulate, closed-loop, "
                         ">= 2 replicas)")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="periodic per-replica scheduler snapshot cadence in "
                         "batches — the crash-recovery anchor (default 20 "
                         "with --crash-at, else 0 = off)")
    ap.add_argument("--metrics-log", default=None, metavar="PATH",
                    help="write periodic cluster metrics_snapshot samples "
                         "(per-replica queue depth, KV device/host occupancy, "
                         "preemptions, swaps, prefix-hit ratio, router "
                         "spills) as JSONL (simulate, closed-loop)")
    ap.add_argument("--metrics-interval", type=float, default=5.0,
                    help="simulated seconds between --metrics-log samples")
    ap.add_argument("--device", default=None,
                    help="real mode's torch device (default cuda; pass 'cpu' "
                         "to run on the CPU); --simulate uses no device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.num_replicas < 1:
        raise SystemExit("--num-replicas must be >= 1")
    if args.simulate and args.device is not None:
        raise SystemExit("--simulate runs on the simulated clock and uses no "
                         "torch device; drop --device")
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
    if args.plan != "off" and args.open_loop:
        raise SystemExit("--plan rewrites a closed-loop trace replay; it does "
                         "not apply to the scripted --open-loop session")
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
    elastic = (args.autoscale or args.crash_at is not None
               or args.metrics_log is not None)
    if elastic and not args.simulate:
        raise SystemExit("--autoscale/--crash-at/--metrics-log drive the "
                         "elastic simulated cluster; add --simulate")
    if elastic and (args.open_loop or args.plan != "off"):
        raise SystemExit("--autoscale/--crash-at/--metrics-log run the "
                         "closed-loop elastic replay; drop --open-loop/--plan")
    if args.crash_at is not None and args.crash_at <= 0:
        raise SystemExit(f"--crash-at must be > 0 s (got {args.crash_at})")
    if args.crash_at is not None and args.num_replicas < 2:
        raise SystemExit("--crash-at needs --num-replicas >= 2: the failed "
                         "replica's work must have a survivor to fail over to")
    if (args.min_replicas is not None or args.max_replicas is not None) \
            and not args.autoscale:
        raise SystemExit("--min-replicas/--max-replicas only apply with "
                         "--autoscale")
    if args.snapshot_every is not None and args.snapshot_every < 0:
        raise SystemExit(f"--snapshot-every must be >= 0 batches "
                         f"(got {args.snapshot_every})")
    if args.snapshot_every is not None and not args.simulate:
        raise SystemExit("--snapshot-every only applies with --simulate")
    if args.metrics_interval <= 0:
        raise SystemExit(f"--metrics-interval must be > 0 s "
                         f"(got {args.metrics_interval})")
    min_replicas = args.min_replicas if args.min_replicas is not None else 1
    max_replicas = args.max_replicas if args.max_replicas is not None \
        else max(4, 2 * args.num_replicas)
    if args.autoscale and not (min_replicas <= args.num_replicas
                               <= max_replicas):
        raise SystemExit(f"--autoscale needs --min-replicas <= --num-replicas "
                         f"<= --max-replicas (got {min_replicas} / "
                         f"{args.num_replicas} / {max_replicas})")
    snapshot_every = args.snapshot_every if args.snapshot_every is not None \
        else (20 if args.crash_at is not None else 0)
    lm = a100_opt13b()
    limits = BatchLimits() if args.kv_cap is None else BatchLimits(cap=args.kv_cap)
    prefix_sharing = args.prefix_sharing == "on"
    host_kv_cap = args.host_kv_cap if args.host_kv_cap is not None \
        else 4 * limits.cap
    swap_bandwidth = args.swap_bandwidth if args.swap_bandwidth is not None \
        else 32.0
    tiering_kw = dict(kv_tiering=kv_tiering,
                      host_kv_cap=host_kv_cap if kv_tiering else 0,
                      swap_bandwidth_gbps=swap_bandwidth,
                      proactive_offload=proactive_offload,
                      idle_horizon_s=args.idle_horizon,
                      swap_prefetch=swap_prefetch,
                      debug_invariants=args.debug_invariants)

    if args.simulate:
        ds = make_dataset(args.dataset, num_rows=10_000, seed=args.seed)
        trace = build_trace(ds, TraceConfig(
            num_relqueries=args.num_relqueries, rate=args.rate, seed=args.seed,
            max_requests=args.max_requests,
            dup_row_fraction=args.dup_row_fraction))
        dpu = DPUConfig(starvation_threshold=args.starvation_threshold,
                        exact_probe=args.dpu_exact_probe)
        cluster = build_simulated_cluster(
            args.num_replicas, scheduler=args.scheduler, latency_model=lm,
            router_policy=args.router, dpu_config=dpu, seed=args.seed,
            limits=limits, kv_admission=args.kv_admission,
            prefix_sharing=prefix_sharing, engine_loop=args.engine_loop,
            snapshot_every=snapshot_every, **tiering_kw)
        print(f"scheduler={args.scheduler} replicas={args.num_replicas} "
              f"router={args.router} kv-admission={args.kv_admission} "
              f"prefix-sharing={args.prefix_sharing} "
              f"engine-loop={args.engine_loop} kv-tiering={args.kv_tiering}")
        if args.open_loop:
            report = run_open_loop(Frontend(cluster), trace)
            _print_report("open-loop", report)
        elif args.plan != "off":
            report = run_planned(Frontend(cluster), trace, args.plan)
            _print_report("planned", report)
        elif elastic:
            if args.autoscale:
                cluster.attach_autoscaler(Autoscaler(cluster, AutoscaleConfig(
                    min_replicas=min_replicas, max_replicas=max_replicas)))
            fe = Frontend(cluster)
            try:
                result = run_elastic_replay(
                    fe, cluster, trace, crash_at=args.crash_at,
                    metrics_log=args.metrics_log,
                    metrics_interval=args.metrics_interval)
            finally:
                fe.close()
            for i, rep in enumerate(result.per_replica):
                _print_report(f"replica {i}", rep)
            _print_report("merged", result.merged)
            report = result.merged
            if result.scale_events:
                adds = sum(1 for e in result.scale_events
                           if e["action"] == "add")
                drains = sum(1 for e in result.scale_events
                             if e["action"] == "drain")
                print(f"[autoscale] {adds} replicas added, {drains} drained; "
                      f"final fleet {result.replica_states}")
        else:
            result = cluster.run_trace(trace)
            for i, rep in enumerate(result.per_replica):
                _print_report(f"replica {i}", rep)
            _print_report("merged", result.merged)
            report = result.merged
        if args.num_replicas > 1 or elastic:
            stats = cluster.router.stats
            print(f"router: {stats['routed']} routed, "
                  f"{stats['spilled']} spilled, "
                  f"{stats['template_homes']} live template homes "
                  f"({stats['template_homes_created']} created)")
    else:
        from repro_torch.configs import get_smoke_config
        from repro_torch.engine.tokenizer import HashTokenizer
        from repro_torch.models.registry import build_model
        from repro_torch.serving import build_real_engine

        if args.num_replicas != 1:
            raise SystemExit("real mode runs a single replica on one device; "
                             "use --simulate for --num-replicas > 1")
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(str(e))
        cfg = get_smoke_config(args.arch)
        model = build_model(cfg)
        params = model.init_params(
            torch.Generator(device=device).manual_seed(args.seed))
        tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
        ds = make_dataset(args.dataset, num_rows=1000, seed=args.seed)
        # output_token_cap keeps decoding short without mutating the built
        # trace (relQueries are immutable once constructed)
        trace = build_trace(ds, TraceConfig(
            num_relqueries=min(args.num_relqueries, 8), rate=args.rate,
            seed=args.seed, max_requests=min(args.max_requests, 8),
            output_token_cap=8,
            dup_row_fraction=args.dup_row_fraction), tokenizer=tok)
        try:
            engine = build_real_engine(
                args.arch, args.scheduler, args.kv_backend, limits=limits,
                latency_model=lm, kv_admission=args.kv_admission,
                prefix_sharing=prefix_sharing, max_slots=64, max_len=1024,
                model=model, params=params, engine_loop=args.engine_loop,
                dpu_config=DPUConfig(
                    starvation_threshold=args.starvation_threshold,
                    exact_probe=args.dpu_exact_probe)
                if args.scheduler.startswith("relserve") else None,
                device=device, **tiering_kw)
        except NotImplementedError as e:
            raise SystemExit(f"--kv-backend {args.kv_backend}: {e}")
        print(f"scheduler={args.scheduler} kv-backend={args.kv_backend} "
              f"engine-loop={args.engine_loop} kv-tiering={args.kv_tiering} "
              f"device={device}")
        if args.open_loop:
            report = run_open_loop(Frontend(engine), trace)
            _print_report("open-loop", report)
        elif args.plan != "off":
            report = run_planned(Frontend(engine), trace, args.plan,
                                 tokenizer=tok)
            _print_report("planned", report)
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
