"""The harness end to end on the CPU at a tiny size: a run is correct,
the timed path broken underneath makes it incorrect, a new mix and
configuration are found by name, and the command refuses to run without
a card."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _relbench_tiny import config, mix
from relbench import harness, weights
from relbench.readers import percentile
from relbench.reference.model import Reference

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _open_loop():
    """Short answers and a long drain: a loaded host slows the run, and
    lateness is not what these tests look at."""
    return mix("relq_poisson", rate_relq_per_s=4.0, rows=[2, 6], drain_s=300,
               templates=["filter", "classify", "rating"], warmup_relqueries=1,
               check_tokens=100, check_rows_max=16)


SEED = 2 ** 31 + 7


def _run(m, metrics=(), seconds=1.5, fault=None, cfg=None):
    t0 = time.perf_counter()
    cell = harness.Cell({"name": "tiny", "chips": 1}, cfg or config(), m,
                        list(metrics), ROOT)
    return harness.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                            clock=lambda: time.perf_counter() - t0,
                            log=lambda *a, **k: None, fault=fault)


def _metric(name):
    return next(m for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]
                if m["name"] == name)


def test_open_loop_run_is_correct():
    names = ["relq_latency_mean_s", "row_latency_p95_s", "setup_s",
             "queue_wait_p95_s", "sched_ms_per_batch.poisson",
             "prefix_hit_ratio.poisson", "prefill_ms_per_ktok.poisson",
             "capture_s", "mfu.poisson"]
    out = _run(_open_loop(), [_metric(n) for n in names])
    line = out.line
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == 6
    assert list(line)[-1] == "checks"
    assert line["checks"]["served_logit_gap"]["value"] <= 1e-3
    got = line["metrics"]
    assert set(names) - {"capture_s"} <= set(got)   # no graphs on the CPU
    assert got["row_latency_p95_s"]["value"] >= got["queue_wait_p95_s"]["value"] > 0
    assert 0 < got["mfu.poisson"]["value"] < 100
    assert json.loads(json.dumps(line)) == line


def test_backlog_run_counts_tokens():
    m = mix("relq_bulk_short", backlog_relqueries=12, warmup_relqueries=1,
            check_tokens=60, check_rows_max=12)
    out = _run(m, [_metric("output_tokens_per_s.bulk_short"),
                   _metric("decode_step_ms.bulk_short")], seconds=3.0)
    assert out.line["correct"]
    assert out.line["metrics"]["output_tokens_per_s.bulk_short"]["value"] == \
        out.run.output_tokens / 3.0 > 0


def _alter_token(engine):
    """Served tokens altered where they are produced (every even one, so
    that each row the check samples has some, however the rows batch)."""
    ex = engine.executor
    sample = ex._sample

    def altered(logits):
        out = sample(logits)
        return np.where(out % 2 == 0, (out + 1) % logits.shape[-1], out)

    ex._sample = altered


def _state_unchanged(engine):
    """A decode step that leaves its state (the KV pools) unchanged."""
    model = engine.executor.model
    step = model.decode_step_paged

    def unchanged(params, pools, *a, **k):
        logits, _ = step(params, {n: p.clone() for n, p in pools.items()}, *a, **k)
        return logits, pools

    model.decode_step_paged = unchanged


def _half_batch(engine):
    """Half of a decode batch left out: its rows take the other half's
    logits."""
    model = engine.executor.model
    step = model.decode_step_paged

    def halved(*a, **k):
        logits, pools = step(*a, **k)
        h = logits.shape[0] // 2
        if h:
            logits[h:2 * h] = logits[:h].clone()
        return logits, pools

    model.decode_step_paged = halved


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch"])
def test_broken_timed_path_is_not_correct(fault):
    out = _run(_open_loop(), fault=fault)
    assert not out.line["correct"]
    assert out.line["checks"]["served_logit_gap"]["value"] > 1e-3


def _new_decode_steps(engine):
    """Set-up's decode steps dropped: the window makes them again, as it
    would capture a bucket that set-up did not reach."""
    engine.executor._decode_fn.clear()


def test_a_step_made_in_the_window_is_not_correct():
    out = _run(_open_loop(), fault=_new_decode_steps)
    assert out.line["checks"]["served_logit_gap"]["value"] <= 1e-3
    assert out.line["checks"]["window_steps"]["value"] > 0
    assert not out.line["correct"]


def _bf16_config():
    """A configuration served in bf16 at a width where the fp8 control
    separates from the program (``test_relbench_reference.py``: the program
    at most 0.0185, the control at least 0.14), with its limit between."""
    return dict(config("bfloat16"), hidden_size=256, intermediate_size=512,
                head_dim=64, num_hidden_layers=4,
                check={"served_logit_gap": 0.06})


def _fp8_control(cfg):
    """The control in the program's place: every served token is the one
    the reference in fp8 puts first after the row's prompt and the tokens
    served so far (the program then decodes on from the control's tokens)."""
    ref = Reference(cfg, weights.make(cfg, SEED, "cpu"), quant="fp8")

    def fault(engine):
        ex = engine.executor
        wait = ex.wait

        def control(inflight):
            dur, result = wait(inflight)
            rows = {r.req_id: r for r in (*inflight.batch.prefill_requests,
                                          *inflight.batch.decode_requests)}
            ids = list(result.outputs)
            seqs = [list(rows[i].tokens) + list(rows[i].output_tokens) for i in ids]
            for i, lg in zip(ids, ref.logits(seqs, [[len(q) - 1] for q in seqs])):
                result.outputs[i] = (int(lg[0].argmax()), result.outputs[i][1])
            return dur, result

        ex.wait = control

    return fault


@pytest.mark.parametrize("control", [False, True], ids=["bf16_program", "fp8_control"])
def test_fp8_control_is_not_correct_at_the_configuration_limit(control):
    """Through a whole run: the bf16 program passes its configuration's
    limit, the fp8 control put in its place fails it."""
    cfg = _bf16_config()
    # few short rows, and a short drain: the control's reference runs once
    # for every batch, and the rows it finishes are what the check reads
    m = dict(_open_loop(), rows=[1, 3], templates=["filter", "rating"], drain_s=10)
    out = _run(m, cfg=cfg, fault=_fp8_control(cfg) if control else None)
    gap = out.line["checks"]["served_logit_gap"]
    assert out.line["correct"] is (not control), gap
    assert (gap["value"] > gap["limit"]) is control


def test_new_mix_and_configuration_are_found_by_name(tmp_path):
    """A mix file, a configuration file and manifest entries: no edit of
    any file of the harness."""
    shutil.copytree(ROOT / "relbench", tmp_path / "relbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "relbench" / "traffic" / "relq_tiny.json").write_text(
        json.dumps(_open_loop()))
    (tmp_path / "relbench" / "configs" / "tiny.json").write_text(json.dumps(config()))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "relbench/configs/tiny.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "tiny.relq_tiny", "config": "tiny",
                             "traffic": "relq_tiny", "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("relq_latency_mean_s", "queue_wait_p95_s"):
            m["workloads"].append("tiny.relq_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.resolve("tiny.relq_tiny", False, root=tmp_path)
    assert cell.mix["rate_relq_per_s"] == 4.0 and cell.config["name"] == "tiny"
    assert [m["name"] for m in cell.metrics] == ["relq_latency_mean_s", "setup_s"]
    assert [m["name"] for m in harness.resolve("tiny.relq_tiny", True,
                                               root=tmp_path).metrics] == \
        ["queue_wait_p95_s"]
    t0 = time.perf_counter()
    out = harness.run_cell(cell, 3, 1.5, False, torch.device("cpu"),
                           clock=lambda: time.perf_counter() - t0,
                           log=lambda *a, **k: None)
    assert out.line["correct"]
    assert set(out.line["metrics"]) == {"relq_latency_mean_s", "setup_s"}


def test_every_metric_has_a_reader_that_finds_nothing_in_an_empty_run():
    run = harness.Run(_open_loop(), {"L": 1}, 1.0)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        value = harness.reader(m["name"])(run)
        if m["name"] in ("setup_s", "capture_s"):
            assert value == 0.0
        else:
            assert value is None, m["name"]


def test_percentile_interpolates():
    assert percentile([1, 2, 3, 4, 5], 0.95) == pytest.approx(4.8)
    assert percentile([7], 0.95) == 7


@pytest.mark.parametrize("root", ["checkout", "benchmark_only"])
def test_command_refuses_without_a_card(tmp_path, root):
    """No CUDA device here: the command exits non-zero and prints no
    result; so does a directory that holds only the benchmark's files."""
    cwd = ROOT
    if root == "benchmark_only":
        shutil.copytree(ROOT / "relbench", tmp_path / "relbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    p = subprocess.run([sys.executable, "relbench/run.py", "--workload",
                        MANIFEST["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=cwd, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
