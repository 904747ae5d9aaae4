"""``tools/trace_cell.py``: its readings of the program's spans and queued
records on a synthetic run, each worked out by hand, and nothing read where
there are no records; the idle split by program span on the profiler's
clock; and a run of a tiny cell on the CPU with the tracer attached."""
import importlib.util
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from relbench import harness  # noqa: E402
from repro_torch.engine.trace import Queued, Records, Span  # noqa: E402


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tc = _load("trace_cell", REPO / "tools" / "trace_cell.py")
tiny = _load("relbench_tiny", REPO / "relbench" / "tests" / "_relbench_tiny.py")


def _span(name, start_ms, end_ms, parent=None, batch=0, **attrs):
    return Span(name, int(start_ms * 1e6), int(end_ms * 1e6), parent, batch, attrs)


class _Req:
    def __init__(self, req_id):
        self.req_id = req_id


def _run():
    """Three window batches and a fourth after the window:

    - 0, mixed: prefill.prep 1 ms, step.load 0.2, decode.prep 3 (a cow of
      1 in it, a step.load of 0.1 in that), step.replay 5; device 40 ms of
      prefill over 500 uncached tokens, 10 of decode;
    - 1, decode: decode.prep 2, step.load 0.3; device decode 14;
    - 2, prefill: prefill.prep 0.5; device prefill 110 over 1,500 tokens;
    - 3, decode, outside the window: decode.prep 50; device decode 99.

    Rows r1-r3 are window rows queued 0.5, 2.0 and 1.0 s; r4 (10 s) is
    not."""
    run = harness.Run(tiny.mix("relq_poisson"), {"L": 1}, 1.0)
    run.t0, run.t1 = 0.0, 1.0
    spans = []
    t0 = _span("tick", 0, 100, kind="mixed", prefill=1, decode=2, uncached_tokens=500,
               device_prefill_ms=40.0, device_decode_ms=10.0)
    d0 = _span("dispatch", 1, 20, t0)
    dp = _span("decode.prep", 3, 6, d0)
    cow = _span("cow", 4, 5, dp)
    spans += [t0, d0, _span("prefill.prep", 1, 2, d0), _span("step.load", 2, 2.2, d0),
              dp, cow, _span("step.load", 4, 4.1, cow), _span("step.replay", 6, 11, d0)]
    t1 = _span("tick", 100, 200, batch=1, kind="decode", prefill=0, decode=3,
               uncached_tokens=0, device_prefill_ms=None, device_decode_ms=14.0)
    d1 = _span("dispatch", 101, 110, t1, batch=1)
    spans += [t1, d1, _span("decode.prep", 101, 103, d1, batch=1),
              _span("step.load", 103, 103.3, d1, batch=1)]
    t2 = _span("tick", 200, 300, batch=2, kind="prefill", prefill=2, decode=0,
               uncached_tokens=1500, device_prefill_ms=110.0, device_decode_ms=None)
    d2 = _span("dispatch", 201, 210, t2, batch=2)
    spans += [t2, d2, _span("prefill.prep", 201, 201.5, d2, batch=2)]
    t3 = _span("tick", 1000, 1100, batch=3, kind="decode", prefill=0, decode=3,
               uncached_tokens=0, device_prefill_ms=None, device_decode_ms=99.0)
    spans += [t3, _span("decode.prep", 1001, 1051, t3, batch=3)]
    run.batches = [harness.BatchRecord(0.0, 0.1, [5], [6, 7]),
                   harness.BatchRecord(0.1, 0.2, [], [6, 7, 8]),
                   harness.BatchRecord(0.2, 0.3, [5, 5], []),
                   harness.BatchRecord(1.0, 1.1, [], [6, 7, 8])]
    requests = {"r1": Queued("r1", "q1", 1.0, 1.5), "r2": Queued("r2", "q1", 1.0, 3.0),
                "r3": Queued("r3", "q2", 2.0, 3.0), "r4": Queued("r4", "q0", 0.0, 10.0)}
    for rid, window in (("r1", True), ("r2", True), ("r3", True), ("r4", False)):
        run.rows[rid] = harness.Row(_Req(rid), 0.0, window)
    return run, Records(spans, requests)


@pytest.mark.parametrize("name,value", [
    ("prefill_device_ms_per_ktok", (40.0 + 110.0) / 2.0),
    ("decode_device_ms", (10.0 + 14.0) / 2),
    ("dispatch_host_ms", (1 + 0.2 + 3 + 2 + 0.3 + 0.5) / 3),
    # [0.5, 1.0, 2.0]: 1.0 + 0.9 * (2.0 - 1.0)
    ("row_queue_p95_s", 1.9),
])
def test_reading_by_hand_over_the_window_batches(name, value):
    run, records = _run()
    assert tc.report(run, records, 0)[name] == pytest.approx(value)


def test_an_empty_run_reads_nothing():
    rep = tc.report(harness.Run(tiny.mix("relq_poisson"), {"L": 1}, 1.0), Records(), 0)
    assert [rep[k] for k in ("prefill_device_ms_per_ktok", "decode_device_ms",
                             "dispatch_host_ms", "row_queue_p95_s")] == [None] * 4
    assert "idle_by_span" not in rep


@pytest.mark.parametrize("name", ["prefill_device_ms_per_ktok", "decode_device_ms"])
def test_device_readings_are_none_without_device_times(name):
    """On the CPU no step is timed: both device times are None."""
    run, records = _run()
    for s in records.spans:
        if s.name == "tick":
            s.attrs.update(device_prefill_ms=None, device_decode_ms=None)
    assert tc.report(run, records, 0)[name] is None


def test_batches_by_kind_and_decode_only_against_the_host_sample():
    run, records = _run()
    run.decode_samples = [(2, 0.009), (3, 0.015)]   # the two window decodes
    b = tc.report(run, records, 0)["batches"]
    assert b["kinds"] == {"decode": {"n": 1, "prefill_rows": 0, "decode_rows": 3},
                          "mixed": {"n": 1, "prefill_rows": 1, "decode_rows": 2},
                          "prefill": {"n": 1, "prefill_rows": 2, "decode_rows": 0}}
    assert b["both_phases"] == 1
    assert b["decode_only_above_host_sample"] == [0, 1]   # 14 ms against 15
    assert b["captured"] == []


def test_ticks_must_match_the_runs_batches():
    run, records = _run()
    run.batches.pop()
    with pytest.raises(RuntimeError, match="tick spans"):
        tc.report(run, records, 0)


def test_idle_gaps_go_to_the_innermost_program_span_on_the_profilers_clock():
    """Gaps (profiler ns) against spans shifted by ``offset_ns``: a gap in
    a prefill sample, one in dispatch outside its children, one outside
    every span; the program's dispatch and wait hold 1.5 of the harness's
    2 us there."""
    tick = Span("tick", 0, 10_000, None, 0, {})
    dispatch = Span("dispatch", 1_000, 4_000, tick, 0, {})
    wait = Span("wait", 5_000, 9_000, tick, 0, {})
    sample = Span("sample", 6_000, 8_000, wait, 0, {"phase": "prefill"})
    gaps = [(4_000, 4_500), (7_000, 8_000), (11_500, 12_500)]
    spans = [tick, dispatch, wait, sample]
    assert tc.idle_by_span(gaps, spans, 1000) == pytest.approx(
        {"dispatch": 500e-9, "sample.prefill": 1000e-9, "outside": 1000e-9})
    run = harness.Run(tiny.mix("relq_poisson"), {"L": 1}, 1.0)
    run.trace = {"idle_gaps": {"dispatch": 800e-9, "wait": 1200e-9, "loop": 5.0}}
    assert tc.program_share(run, gaps, Records(spans, {}), 1000) == pytest.approx(0.75)


def test_timed_steps_sum_over_the_traced_batches():
    run, records = _run()
    run.trace_span = (0.1, 1.2)
    assert tc.timed_step_s(run, records) == pytest.approx(1e-3 * (14 + 110 + 99))


def test_a_tiny_cell_served_with_the_tracer_attached():
    """``traced_run`` on the CPU: the tracer attached before the window
    holds one tick per batch, the readings of host spans and queued records
    read, the device times do not (no events on the CPU), and the run is
    correct."""
    m = tiny.mix("relq_poisson", rate_relq_per_s=4.0, rows=[2, 6], drain_s=300,
                 templates=["filter", "classify", "rating"], warmup_relqueries=1,
                 check_tokens=100, check_rows_max=16)
    cell = harness.Cell({"name": "tiny", "chips": 1}, tiny.config(), m, [], REPO)
    t0 = time.perf_counter()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, rep = tc.traced_run(cell, 2 ** 31 + 7, 1.5, False, torch.device("cpu"),
                                 lambda: time.perf_counter() - t0,
                                 log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(n)
    assert out.line["correct"]
    assert rep["dispatch_host_ms"] > 0 and rep["row_queue_p95_s"] >= 0
    assert rep["prefill_device_ms_per_ktok"] is None and rep["decode_device_ms"] is None
    assert sum(k["n"] for k in rep["batches"]["kinds"].values()) == len(
        out.run.window_batches())
    assert rep["batches"]["both_phases"] == 0
