"""Run one cell of the port's benchmark once and print its result.

    python3 relbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; ``harness.py`` says what a run does. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``
last); the last lines of standard error give each number the check
compared beside its limit. Exits non-zero, printing no result, without
the CUDA devices the cell asks for, and if the process has loaded JAX or
the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    from relbench import harness

    cell = harness.resolve(args.workload, bool(args.trace))
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"[relbench] {args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0),
                           clock=lambda: time.perf_counter() - T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[relbench] the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out.line["checks"].items():
        print(f"[relbench] check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
