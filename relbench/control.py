"""Readings of the check's numbers, to set a cell's limit from: the
program's widest served-token gap on many seeds, and the control's.

    python3 relbench/control.py --workload qwen2.5-32b.relq_poisson \
        --seeds 101,102,103 --control-seeds 101,102,103 --seconds 20 \
        --out chiprun_out/control.jsonl

One set-up on the first seed; each further seed redraws the weights in
place (the captured graphs read them where they are) and serves its own
traffic through a window of ``--seconds`` at the
cell's load, then the check's sample (``harness.check_sample``) goes
through the float32 reference. On the control seeds the same prompts and
served tokens also go through the reference computed in fp8
(``Reference(quant="fp8")``, the precision below the configuration's
bf16): its reading is the gap, in the float32 reference, of the token the
fp8 forward puts first at each position. The benchmark's own runs never
run the control.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from relbench import tools  # noqa: E402

T0 = tools.start()


def main(argv=None) -> int:
    import time

    import torch
    from relbench import harness, weights
    from relbench.reference.model import control_gap
    from relbench.traffic import gen

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    clock = lambda: time.perf_counter() - T0  # noqa: E731
    cell = harness.resolve(args.workload, False)
    cfg, mix = cell.config, cell.mix
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    out = open(args.out, "w") if args.out else None
    served = None
    for seed in seeds:
        specs = gen.build(mix, seed, args.seconds, stream=f"s{seed}_")
        rqs = harness.relqueries(specs)
        if served is None:
            warm = harness.relqueries(gen.build(
                mix, seed, args.seconds, stream="warmup",
                count=int(mix["warmup_relqueries"])))
            served = harness.set_up(cfg, mix, seed, rqs + warm, dev, clock)
        else:
            weights.fill(served.params, cfg, seed)
        run = harness.Run(mix, weights.dims(cfg), args.seconds)
        harness.serve_window(served, rqs, specs, mix, run, clock)
        sample = harness.sample_of(run, seed)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        gaps = harness.reference_gaps(cfg, served.params, sample)
        rec = {"workload": args.workload, "seed": seed, "rows": len(sample),
               "served_tokens": sum(len(s["served"]) for s in sample),
               "short": sum(len(s["served"]) != s["limit"] for s in sample),
               "program_gap": max(gaps) if gaps else None,
               "window_steps": run.window_steps,
               "reference_s": time.perf_counter() - t}
        if seed in ctl:
            f32 = harness.reference_logits(cfg, served.params, sample)
            fp8 = harness.reference_logits(cfg, served.params, sample, quant="fp8")
            rec["control_gap"] = max(control_gap(a, b) for a, b in zip(f32, fp8))
        tools.emit(out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
