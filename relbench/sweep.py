"""The rate sweep of an open-loop cell: the highest arrival rate the
program sustains, found once on the chip to fix the cell's rate.

    python3 relbench/sweep.py --workload qwen2.5-32b.relq_poisson --seed 7 \
        --seconds 30 --rates 0.3,0.4,0.5 --out chiprun_out/sweep.jsonl

One set-up, then one window per rate (fresh relQueries, the mix's rate
replaced), each followed by its drain. Per rate: the relQueries due, how
many failed, the mean relQuery latency of the first and the last third of
the window's arrivals (a growing backlog shows as a rising ratio), the p95
row latency, and the rows and tokens completed per second.
"""
import argparse
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from relbench import tools  # noqa: E402

T0 = tools.start()


def main(argv=None) -> int:
    import time

    import torch
    from relbench import harness, weights
    from relbench.readers import percentile
    from relbench.traffic import gen

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    clock = lambda: time.perf_counter() - T0  # noqa: E731
    cell = harness.resolve(args.workload, False)
    cfg, mix = cell.config, dict(cell.mix)
    rates = [float(r) for r in args.rates.split(",")]
    dev = torch.device("cuda", 0)
    mix["rate_relq_per_s"] = max(rates)
    traffic = harness.relqueries(
        gen.build(mix, args.seed, args.seconds)
        + gen.build(mix, args.seed, args.seconds, stream="warmup",
                    count=int(mix["warmup_relqueries"])))
    served = harness.set_up(cfg, mix, args.seed, traffic, dev, clock)
    out = open(args.out, "w") if args.out else None
    for i, rate in enumerate(rates):
        m = dict(mix, rate_relq_per_s=rate)
        specs = gen.build(m, args.seed, args.seconds, stream=f"sweep{i}_")
        rqs = harness.relqueries(specs)
        run = harness.Run(m, weights.dims(cfg), args.seconds)
        harness.serve_window(served, rqs, specs, m, run, clock)
        core = served.engine.core
        while core.tick(clock()) is not None:    # the next rate starts empty
            pass
        rows = [r for r in run.rows.values() if r.window]
        by = {}
        for r in rows:
            by.setdefault(r.req.rel_id, []).append(r)
        lat = {k: (max(r.finish for r in v) - v[0].due)
               for k, v in by.items() if all(r.finish is not None for r in v)}
        order = sorted(by, key=lambda k: by[k][0].due)
        third = max(1, len(order) // 3)
        first = [lat[k] for k in order[:third] if k in lat]
        last = [lat[k] for k in order[-third:] if k in lat]
        done = [r for r in rows if r.finish is not None]
        tools.emit(out, {
            "rate": rate, "relqueries": len(by), "failed": len(by) - len(lat),
            "rows": len(rows),
            "relq_latency_mean_s": statistics.fmean(lat.values()) if lat else None,
            "first_third_mean_s": statistics.fmean(first) if first else None,
            "last_third_mean_s": statistics.fmean(last) if last else None,
            "row_latency_p95_s": percentile([r.finish - r.due for r in done], 0.95)
            if done else None,
            "rows_per_s": sum(1 for r in done if r.finish <= run.t1) / args.seconds,
            "tokens_per_s": run.output_tokens / args.seconds,
            "drain_s": run.end - run.t1, "window_steps": run.window_steps,
            "late_max_s": max(run.lateness) if run.lateness else 0.0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
