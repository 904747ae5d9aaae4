"""Run one cell of the port's benchmark with the program's tracer attached,
and report what the serving path's own spans and per-step CUDA events show.

    python3 tools/trace_cell.py --workload <cell> --seed <n> [--seconds 51] \
        [--profile 1] [--out build/trace_cell.jsonl]

From the root of a checkout, on a card. The run is ``relbench/run.py``'s
(``relbench.harness.run_cell``: the same set-up, window, check and result
line); a ``Tracer`` (``repro_torch.engine.trace``) is attached to the
engine's core and executor after set-up, right before the window, through
``run_cell``'s ``fault`` hook. ``--profile 1`` makes it a ``--trace 1`` run
(the window's last seconds under ``torch.profiler``, the per-layer metrics);
``--profile 0`` a ``--trace 0`` run, whose end-to-end metrics against
``run.py --trace 0`` on the same seed give the tracer's cost.

Reported over the window's batches (``Run.window_batches``; the tracer keeps
one ``tick`` span for each batch the engine ran, in order):

- ``prefill_device_ms_per_ktok``: the ticks' ``device_prefill_ms`` (the
  prefill steps' CUDA events) per 1,000 uncached prompt tokens;
- ``decode_device_ms``: the mean ``device_decode_ms`` of the batches that
  decode;
- ``dispatch_host_ms``: host ms a batch in ``DISPATCH_HOST`` spans, the
  dispatch work the device waits for in the serial loop;
- ``row_queue_p95_s``: the 95th percentile over the window relQueries' rows
  of admission to the tick that first scheduled the row (``Queued``);
- ``batches``: the batches by kind, their mean prefill and decode rows, how
  many ran both phases on the device, and of those that only decoded how
  many read more device ms than their host decode sample; the buckets
  captured in the window.

Profiled, over the traced sub-window: ``idle_by_span``, each idle gap put
against the innermost program span that holds its middle (on the profiler's
clock, through ``offset_ns``; ``sample`` by its phase; ``outside`` where no
span does); ``program_share``, the idle the program's ``dispatch`` and
``wait`` hold over the idle the harness's own ``dispatch`` and ``wait``
spans hold; and ``timed_step_s`` (the traced batches' step events summed)
beside ``busy_s``.

Prints the result line as ``run.py`` does, then one JSON object of the
above (last line), which ``--out`` also appends to a file.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from relbench import harness, profile  # noqa: E402
from relbench.readers import percentile, window_rows  # noqa: E402
from repro_torch.engine.trace import Records, Tracer  # noqa: E402

_label_gaps = profile._label   # idle gaps by the innermost span of a list

# the dispatch work the device waits for in the serial loop: host
# preparation of a batch's steps and each step's input copy
DISPATCH_HOST = ("prefill.prep", "decode.prep", "cow", "step.load")


def attach(engine) -> Tracer:
    """A tracer on the engine's core and executor."""
    tracer = Tracer()
    engine.core.tracer = engine.executor.tracer = tracer
    return tracer


def ticks_of(run: harness.Run, records: Records) -> list:
    """``(batch record, tick span)`` of each of the run's batches."""
    ticks = [s for s in records.spans if s.name == "tick"]
    if len(ticks) != len(run.batches):
        raise RuntimeError(f"{len(ticks)} tick spans for {len(run.batches)} "
                           "batches: the tracer was not attached before the "
                           "first batch")
    return list(zip(run.batches, ticks))


def window_spans(run: harness.Run, records: Records) -> list:
    """The spans of the window's batches."""
    window = {id(b) for b in run.window_batches()}
    ids = {t.batch for b, t in ticks_of(run, records) if id(b) in window}
    return [s for s in records.spans if s.batch in ids]


def _ticks(spans) -> List[dict]:
    return [s.attrs for s in spans if s.name == "tick"]


def prefill_device_ms_per_ktok(spans) -> Optional[float]:
    timed = [a for a in _ticks(spans) if a.get("device_prefill_ms") is not None]
    tokens = sum(a["uncached_tokens"] for a in timed)
    if tokens <= 0:
        return None
    return sum(a["device_prefill_ms"] for a in timed) / (tokens / 1000.0)


def decode_device_ms(spans) -> Optional[float]:
    ms = [a["device_decode_ms"] for a in _ticks(spans)
          if a.get("device_decode_ms") is not None]
    return statistics.fmean(ms) if ms else None


def dispatch_host_ms(spans) -> Optional[float]:
    """Each span counted once: one inside another of them is not counted
    again."""
    n = len(_ticks(spans))
    if not n:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name in DISPATCH_HOST and not _inside(s, DISPATCH_HOST))
    return ns * 1e-6 / n


def row_queue_p95_s(run: harness.Run, records: Records) -> Optional[float]:
    waits = []
    for r in window_rows(run):
        q = records.requests.get(r.req.req_id)
        if q is not None and q.scheduled is not None:
            waits.append(q.scheduled - q.admit)
    return percentile(waits, 0.95) if waits else None


def _inside(span, names) -> bool:
    p = span.parent
    while p is not None:
        if p.name in names:
            return True
        p = p.parent
    return False


def batches(run: harness.Run, spans) -> dict:
    ticks = _ticks(spans)
    kinds = {}
    for kind in sorted({a["kind"] for a in ticks}):
        mine = [a for a in ticks if a["kind"] == kind]
        kinds[kind] = {"n": len(mine),
                       "prefill_rows": statistics.fmean(a["prefill"] for a in mine),
                       "decode_rows": statistics.fmean(a["decode"] for a in mine)}
    both = sum(a.get("device_prefill_ms") is not None
               and a.get("device_decode_ms") is not None for a in ticks)
    # the executor's host decode samples align with the batches that decode
    decoded = [a for a in ticks if a.get("device_decode_ms") is not None]
    over = None
    if decoded and len(decoded) == len(run.decode_samples):
        only = [(a["device_decode_ms"], 1e3 * d)
                for a, (_, d) in zip(decoded, run.decode_samples)
                if a["device_prefill_ms"] is None]
        over = [sum(dev > host for dev, host in only), len(only)]
    return {"kinds": kinds, "both_phases": both,
            "decode_only_above_host_sample": over,
            "captured": [list(s.attrs["key"]) for s in spans if s.name == "capture"]}


def _span_label(span) -> str:
    phase = span.attrs.get("phase")
    return f"{span.name}.{phase}" if phase else span.name


def idle_by_span(gaps, spans, offset_ns: int) -> Dict[str, float]:
    """Idle seconds of ``gaps`` (profiler ns) by the innermost of ``spans``
    that holds each gap's middle, ``outside`` where none does."""
    out = _label_gaps(gaps, [(s.start_ns + offset_ns, s.end_ns + offset_ns,
                              _span_label(s)) for s in spans])
    if "loop" in out:
        out["outside"] = out.pop("loop")
    return out


def program_share(run: harness.Run, gaps, records: Records,
                  offset_ns: int) -> Optional[float]:
    """The idle the program's ``dispatch`` and ``wait`` spans hold over the
    idle the harness's ``dispatch`` and ``wait`` spans hold."""
    harness_s = sum(run.trace["idle_gaps"].get(k, 0.0) for k in ("dispatch", "wait"))
    if harness_s <= 0:
        return None
    mine = idle_by_span(gaps, [s for s in records.spans
                               if s.name in ("dispatch", "wait")], offset_ns)
    return (mine.get("dispatch", 0.0) + mine.get("wait", 0.0)) / harness_s


def timed_step_s(run: harness.Run, records: Records) -> float:
    traced = {id(b) for b in run.traced_batches()}
    return 1e-3 * sum((t.attrs.get("device_prefill_ms") or 0.0)
                      + (t.attrs.get("device_decode_ms") or 0.0)
                      for b, t in ticks_of(run, records) if id(b) in traced)


def report(run: harness.Run, records: Records, offset_ns: int,
           gaps=None) -> dict:
    """What the records show of ``run`` (``gaps``: the traced sub-window's
    idle gaps on the profiler's clock, profiled runs only; ``offset_ns``
    puts the records there)."""
    spans = window_spans(run, records)
    out = {"prefill_device_ms_per_ktok": prefill_device_ms_per_ktok(spans),
           "decode_device_ms": decode_device_ms(spans),
           "dispatch_host_ms": dispatch_host_ms(spans),
           "row_queue_p95_s": row_queue_p95_s(run, records),
           "batches": batches(run, spans)}
    if run.trace is not None and gaps is not None:
        out["idle_by_span"] = dict(sorted(
            idle_by_span(gaps, records.spans, offset_ns).items(),
            key=lambda kv: -kv[1]))
        out["program_share"] = program_share(run, gaps, records, offset_ns)
        out["timed_step_s"] = timed_step_s(run, records)
        out["busy_s"] = run.trace["busy_s"]
    return out


def traced_run(cell: harness.Cell, seed: int, seconds: float, prof: bool,
               device, clock, log=print):
    """``harness.run_cell`` with a tracer attached before the window: its
    outcome and ``report``."""
    tracer: List[Tracer] = []
    gaps: list = []

    def keep(g, spans):          # TraceWindow.read's gaps, kept
        gaps[:] = g
        return _label_gaps(g, spans)

    profile._label = keep
    try:
        out = harness.run_cell(cell, seed, seconds, prof, device, clock, log=log,
                               fault=lambda engine: tracer.append(attach(engine)))
    finally:
        profile._label = _label_gaps
    return out, report(out.run, tracer[0].take(), tracer[0].offset_ns,
                       gaps if prof else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        print("[trace_cell] needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload, bool(args.profile))
    out, rep = traced_run(cell, args.seed, args.seconds, bool(args.profile),
                          torch.device("cuda", 0), lambda: time.perf_counter() - T0)
    rep = {"workload": args.workload, "seed": args.seed, "profile": args.profile,
           "line": out.line, **rep}
    print(json.dumps(out.line), flush=True)
    print(json.dumps(rep), flush=True)
    if args.out is not None:
        with open(args.out, "a") as f:
            f.write(json.dumps(rep) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
