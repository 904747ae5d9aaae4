"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py``,
``tools/kernel_ab.py``, ``tools/trace_cell.py`` and the entry module of the
spawned gloo ranks import neither jax nor anything of the JAX package
``repro``; a real serve (a dense, an MoE and a hybrid smoke model), a
simulated multi-replica replay with a crash, a planned real serve and a
training run with a checkpoint run with jax blocked; and the entry points
never fall back to the CPU on their own.

Beside those, small CPU cases of the real executors that need no trace
(2 layers, narrow widths, f32): the swap hooks' pending list and its
materialisation in ``wait()``, a release between a swap-out and that
``wait()``, a swap-in or prefetch issued before it; copy-on-write held
against the JAX executor on a forked sequence; whisper's ``init_cache``
and ``with_layers`` against the reference; and the serving path's tracer
(``engine/trace.py``) on a tiny paged engine: with no tracer a serve reads
no tracer clock and calls no ``record_function``, and serves the tokens a
traced serve does; traced, every tick holds its children nested in time
with its batch id, a batch with a completed prefill and a decode samples
each phase, each request's queued record ends at the tick that first
schedules it; and a program span lines up with the profiler's interval of
the op inside it."""
import ast
import copy
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tools" / "kernel_ab.py",
                                          REPO / "tools" / "trace_cell.py"]
    assert len(files) > 30
    for mod in ("models/moe.py", "models/hymba.py", "models/whisper.py",
                "training/__init__.py", "training/optimizer.py",
                "training/train_step.py", "launch/train.py",
                "models/seq_parallel.py", "distributed/elastic.py",
                "distributed/sharding.py", "distributed/tensor_parallel.py",
                "launch/mesh.py", "launch/hlo_stats.py", "launch/cells.py",
                "launch/dryrun.py", "launch/roofline.py"):
        assert PORT / mod in files, mod
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_torch_testing_internal_is_imported_inside_functions_only():
    """``torch.testing._internal`` (the fake process group of the dry run)
    is a private test package: the port imports it only inside the function
    that needs it, never when a module is imported."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    inside, top = [], []
    for f in files:
        tree = ast.parse(f.read_text(encoding="utf-8"), filename=str(f))
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        in_func = {id(x) for fn in funcs for x in ast.walk(fn)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.startswith("torch.testing._internal") for n in names):
                (inside if id(node) in in_func else top).append(
                    str(f.relative_to(REPO)))
    assert not top, top
    assert "src/repro_torch/launch/mesh.py" in inside


def test_spawned_mesh_ranks_import_neither_jax_nor_repro():
    """The entry module of the gloo ranks that tests/test_torch_layers.py
    spawns imports torch, numpy and repro_torch only (the ranks also report
    their sys.modules: test_torch_layers.py::
    test_gloo_ranks_import_neither_jax_nor_repro)."""
    worker = REPO / "tests" / "_torch_mesh_worker.py"
    roots = {mod.split(".")[0] for mod in _imported_modules(worker)}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


_SERVE_WITHOUT_JAX = r"""
import os
import sys
CKPT = sys.argv[1]
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.configs import get_smoke_config
from repro_torch.data.datasets import make_dataset
from repro_torch.data.trace import TraceConfig, build_trace
from repro_torch.engine.tokenizer import HashTokenizer
from repro_torch.serving import build_real_engine
cfg = get_smoke_config("qwen3-1.7b")
tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
trace = build_trace(make_dataset("rotten", num_rows=64, seed=0),
                    TraceConfig(num_relqueries=2, rate=10.0, seed=0,
                                max_requests=2, output_token_cap=3),
                    tokenizer=tok)
engine = build_real_engine("qwen3-1.7b", "relserve", "paged", device="cpu")
report = engine.run_trace(trace)
assert len(report.latencies) == 2
# the MoE family on the paged engine
moe = get_smoke_config("granite-moe-3b-a800m")
moe_trace = build_trace(make_dataset("rotten", num_rows=64, seed=0),
                        TraceConfig(num_relqueries=2, rate=10.0, seed=0,
                                    max_requests=2, output_token_cap=3),
                        tokenizer=HashTokenizer(vocab_size=moe.vocab_size - 2))
report = build_real_engine("granite-moe-3b-a800m", "relserve", "paged",
                           device="cpu").run_trace(moe_trace)
assert len(report.latencies) == 2
# the hybrid family on the dense engine
hy = get_smoke_config("hymba-1.5b")
hy_trace = build_trace(make_dataset("rotten", num_rows=64, seed=0),
                       TraceConfig(num_relqueries=2, rate=10.0, seed=0,
                                   max_requests=2, output_token_cap=3),
                       tokenizer=HashTokenizer(vocab_size=hy.vocab_size - 2))
report = build_real_engine("hymba-1.5b", "relserve", "dense",
                           device="cpu").run_trace(hy_trace)
assert len(report.latencies) == 2
from repro_torch.launch import serve, train
# a 2-replica simulated replay with a replica crash, then a planned CPU serve
sys.argv = ["serve", "--simulate", "--num-relqueries", "8", "--rate", "3.0",
            "--max-requests", "8", "--num-replicas", "2", "--crash-at", "1.5"]
serve.main()
sys.argv = ["serve", "--device", "cpu", "--kv-backend", "paged", "--plan",
            "full", "--dup-row-fraction", "0.5", "--num-relqueries", "2",
            "--max-requests", "4"]
serve.main()
sys.argv = ["train", "--device", "cpu", "--steps", "2", "--ckpt-every", "2",
            "--ckpt-dir", CKPT]
train.main()
assert os.path.isdir(os.path.join(CKPT, "step_2"))
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("SERVED", sum(len(r.output_tokens) for rq in trace for r in rq.requests))
"""


def test_serves_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX,
                          str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert "SERVED" in out.stdout
    assert "[fault] crashed replica" in out.stdout
    assert "[planned] relqueries=2" in out.stdout


def test_no_device_and_no_card_raises(monkeypatch):
    from repro_torch.serving import build_real_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_real_engine()


# Framework-free modules the port keeps as copies of the reference, with only
# the imports rewritten from repro to repro_torch.
VERBATIM = [
    "configs/__init__.py", "configs/base.py", "configs/gemma3_12b.py", "configs/granite_moe_3b.py",
    "configs/hymba_1p5b.py", "configs/internvl2_26b.py",
    "configs/qwen2_0p5b.py", "configs/qwen2p5_32b.py", "configs/qwen3_1p7b.py",
    "configs/qwen3_moe_30b.py", "configs/rwkv6_7b.py",
    "configs/whisper_base.py", "core/__init__.py", "core/arranger.py",
    "core/batch.py", "core/latency_model.py", "core/policies.py",
    "core/predictor.py", "core/priority.py", "core/relquery.py",
    "core/scheduler.py", "data/datasets.py", "data/tables.py",
    "data/templates.py", "data/trace.py", "engine/engine.py",
    "engine/kv_cache.py", "engine/prefix_cache.py", "engine/simulator.py",
    "engine/tokenizer.py", "planner/__init__.py", "planner/executor.py",
    "planner/passes.py", "planner/plan.py", "planner/planner.py",
    "serving/autoscaler.py", "serving/cluster.py", "serving/frontend.py",
    "serving/router.py",
]


# Copies the port extends with its tracer's sites (``engine/trace.py``): below
# the module docstring, every line of the reference, in order and reindented
# at most, with lines added between.
EXTENDED = ("engine/engine.py",)


def _code_lines(text: str) -> list:
    """The non-empty lines after the module docstring, stripped."""
    start = ast.parse(text).body[1].lineno - 1
    return [ln.strip() for ln in text.splitlines()[start:] if ln.strip()]


def _in_order(lines: list, within: list) -> bool:
    rest = iter(within)
    return all(any(ln == x for x in rest) for ln in lines)


@pytest.mark.parametrize("path", VERBATIM)
def test_framework_free_module_is_a_copy_of_the_reference(path):
    port = (PORT / path).read_text(encoding="utf-8")
    ref = (REPO / "src" / "repro" / path).read_text(encoding="utf-8")
    port = port.replace("repro_torch", "repro")
    if path in EXTENDED:
        assert _in_order(_code_lines(ref), _code_lines(port))
    else:
        assert port == ref


def test_snapshot_codec_is_the_serving_half_of_the_reference():
    """The port's codec is the reference's serving-engine half, from its
    section header to the end of the file; the training checkpoints, before
    that header, are rewritten in torch (their format is held by
    tests/test_torch_transformer.py's cross-load tests)."""
    header = "# serving-engine state snapshots"
    port = (PORT / "distributed" / "fault_tolerance.py").read_text(
        encoding="utf-8").replace("repro_torch", "repro")
    ref = (REPO / "src" / "repro" / "distributed" / "fault_tolerance.py"
           ).read_text(encoding="utf-8")
    assert port[port.index(header):] == ref[ref.index(header):]
    for name in ("save_checkpoint", "load_checkpoint", "latest_step"):
        assert f"def {name}" in ref[:ref.index(header)]
        assert f"def {name}" in port[:port.index(header)]


# ----------------------------------------------------------------------------
# the real executors' host tier and copy-on-write, on the CPU
# ----------------------------------------------------------------------------
def _executor(backend, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.executor import make_real_executor
    from repro_torch.models.registry import build_model

    model = build_model(get_smoke_config("qwen3-1.7b").replace(dtype="float32"))
    params = model.init_params(torch.Generator().manual_seed(0))
    return make_real_executor(backend, model, params, max_slots=4, max_len=128,
                              num_blocks=32, block_size=16, num_host_blocks=32,
                              **kw)


def _two_requests(prefix="swap"):
    from repro_torch.core.relquery import make_relquery

    prompts = [[(7 * i + 3 * j) % 200 + 1 for j in range(21 + 9 * i)]
               for i in range(2)]
    return make_relquery(prefix, prompts, 0.0, 8).requests


def _step(ex, batch):
    """Execute ``batch`` and append each request's token."""
    _, res = ex.execute(batch, 0.0)
    for r in (*batch.prefill_requests, *batch.decode_requests):
        r.output_tokens.append(res.outputs[r.req_id][0])


def _kv_of(ex, r):
    """A copy of request ``r``'s KV: its dense slot or its paged blocks."""
    if hasattr(ex, "slots"):
        i = ex._slot_of[r.req_id]
        return {n: ex._slot_view(n, i).clone() for n in ex.cache}
    table = torch.tensor(ex.bm.block_table(r.req_id))
    return {n: p.index_select(2, table) for n, p in ex.pools.items()}


def _prefilled(backend):
    from repro_torch.core.batch import Batch

    ex = _executor(backend)
    a, b = _two_requests()
    _step(ex, Batch("prefill", prefill_requests=[a, b]))
    return ex, a, b


def _stash_kv(ex, r):
    return ex._host_stash[r.req_id][-1]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_swap_out_stays_pending_until_wait(backend):
    """A swap-out puts its request on ``_pending_host`` with the KV it
    gathered; the next ``wait()`` materialises it, leaving the stash equal
    to the KV before the swap."""
    from repro_torch.core.batch import Batch

    ex, a, b = _prefilled(backend)
    want = _kv_of(ex, a)
    assert ex.swap_out(a.req_id, 0) == 0.0
    assert list(ex._pending_host) == [a.req_id]
    gathered, event = ex._pending_host[a.req_id]
    assert event is None     # the CPU: the gather is the host copy
    assert _stash_kv(ex, a) is gathered
    _step(ex, Batch("decode", decode_requests=[b]))
    assert ex._pending_host == {}
    for n, x in want.items():
        assert torch.equal(_stash_kv(ex, a)[n], x), n
    ex.swap_in(a.req_id, 0)
    for n, x in _kv_of(ex, a).items():
        assert torch.equal(x, want[n]), n


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_release_before_wait_skips_the_pending_swap(backend):
    """A request released (cancelled) between its swap-out and the next
    ``wait()`` is skipped there, as in the reference, and leaves nothing
    behind."""
    from repro_torch.core.batch import Batch

    ex, a, b = _prefilled(backend)
    ex.swap_out(a.req_id, 0)
    ex.release_request(a.req_id)
    assert a.req_id in ex._pending_host and a.req_id not in ex._host_stash
    _step(ex, Batch("decode", decode_requests=[b]))
    assert ex._pending_host == {} and not ex._host_stash
    if backend == "paged":
        ex.bm.check_invariants()
        assert ex.bm.host_free_blocks == ex.bm.num_host_blocks
        assert ex.kv_tokens_resident() == ex.bm.context_len(b.req_id)
    else:
        assert list(ex._slot_of) == [b.req_id]


@pytest.mark.parametrize("hook", ["swap_in", "prefetch"])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_swap_back_before_wait_keeps_the_stream(backend, hook):
    """A swap-in, or a prefetch, issued before the swap-out's ``wait()``
    takes the device gather of the pending swap; the request then decodes
    the stream of a run that never swapped."""
    from repro_torch.core.batch import Batch

    def run(swap):
        ex, a, b = _prefilled(backend)
        if swap:
            ex.swap_out(a.req_id, 0)
            gathered = ex._pending_host[a.req_id][0]
            if hook == "prefetch":
                ex.prefetch_swap_in(a.req_id, 0)
                if backend == "dense":
                    assert ex._prestaged[a.req_id][0] is gathered
                else:
                    assert ex._staged_swap_in[a.req_id][1] is None
                _step(ex, Batch("decode", decode_requests=[b]))
                assert ex._pending_host == {}
            ex.swap_in(a.req_id, 0)
            if hook == "swap_in":
                _step(ex, Batch("decode", decode_requests=[b]))
        else:
            _step(ex, Batch("decode", decode_requests=[b]))
        for _ in range(4):
            _step(ex, Batch("decode", decode_requests=[a, b]))
        if backend == "paged":
            ex.bm.check_invariants()
        return [list(a.output_tokens), list(b.output_tokens)]

    assert run(True) == run(False)


def test_copy_on_write_matches_the_jax_executor():
    """A sequence forked after its prefill shares its parent's partial tail
    block; the parent's first decode copies it (``_copy_block``, one step
    per executor). Greedy streams and ``cow_copies`` equal the JAX paged
    executor's, after the reference's own copy-on-write tests
    (tests/test_paged_parity.py, tests/test_engine_real.py)."""
    import jax
    import numpy as np
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.batch import Batch as JaxBatch
    from repro.core.relquery import make_relquery as jax_make_relquery
    from repro.engine.executor import PagedRealExecutor as JaxPaged
    from repro.models.registry import build_model as jax_build_model
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.batch import Batch
    from repro_torch.core.relquery import make_relquery
    from repro_torch.engine.executor import PagedRealExecutor
    from repro_torch.models.registry import build_model

    arch = "qwen3-1.7b"
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch).replace(dtype="float32"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    prompt = [(5 * j) % 150 + 2 for j in range(21)]   # a partial tail block
    kw = dict(num_blocks=16, block_size=16, max_len=128)
    runs = []
    for ex, make, batch in ((JaxPaged(jm, jp, **kw), jax_make_relquery,
                             JaxBatch),
                            (PagedRealExecutor(tm, tp, **kw), make_relquery,
                             Batch)):
        parent, child = make("cow", [prompt, prompt], 0.0, 8).requests
        _step(ex, batch("prefill", prefill_requests=[parent]))
        ex.bm.fork(parent.req_id, child.req_id)
        ex._active[child.req_id] = child
        child.output_tokens = list(parent.output_tokens)
        for _ in range(5):
            _step(ex, batch("decode", decode_requests=[parent, child]))
        ex.bm.check_invariants()
        assert parent.output_tokens == child.output_tokens
        runs.append((ex.cow_copies, parent.output_tokens))
    assert runs[0] == runs[1] and runs[1][0] == 1, runs


def test_whisper_cache_and_depth_match_the_reference():
    """``WhisperModel.init_cache`` (zeros of ``cache_struct``) and
    ``with_layers`` (encoder and decoder depth) against the reference's."""
    import numpy as np
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model

    jm = jax_build_model(jax_smoke_config("whisper-base")).with_layers(1)
    tm = build_model(get_smoke_config("whisper-base")).with_layers(1)
    assert tm.cfg.num_layers == jm.cfg.num_layers == 1
    assert tm.cfg.num_encoder_layers == jm.cfg.num_encoder_layers == 1
    assert tm.param_count() == jm.param_count()
    assert tm.param_count() < build_model(get_smoke_config("whisper-base")
                                          ).param_count()
    want = jm.init_cache(2, 24)
    got = tm.init_cache(2, 24)
    assert sorted(got) == sorted(want)
    for k, x in got.items():
        assert tuple(x.shape) == want[k].shape, k
        assert str(x.dtype).removeprefix("torch.") == np.dtype(want[k].dtype).name, k
        assert x.device.type == "cpu" and not x.any(), k


# ----------------------------------------------------------------------------
# the serving path's tracer (engine/trace.py) on a tiny paged engine
# ----------------------------------------------------------------------------
_TICK_CHILDREN = {"schedule", "dispatch", "wait", "complete", "listener"}
_DISPATCH_CHILDREN = {"prefill.prep", "decode.prep", "step.load",
                      "step.replay", "capture"}
_WAIT_CHILDREN = {"sample", "finish", "stash"}


@functools.lru_cache(maxsize=None)
def _traced_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.trace import TraceConfig, build_trace
    from repro_torch.engine.tokenizer import HashTokenizer
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    rqs = build_trace(make_dataset("beer", num_rows=64, seed=1),
                      TraceConfig(num_relqueries=3, rate=100.0, seed=4,
                                  max_requests=4, output_token_cap=8),
                      tokenizer=tok)
    return model, params, rqs


def _traced_serve(tracer):
    """Serve the relQueries on a clock of 10 ms a tick, each admitted at
    the first tick after its arrival. Returns the streams, each request's
    admission and first batch's clock, and each batch id's clock."""
    from repro_torch.core.priority import BatchLimits
    from repro_torch.serving import build_real_engine

    model, params, trace_rqs = _traced_model()
    engine = build_real_engine("qwen3-1.7b", "relserve", "paged", model=model,
                               params=params, max_len=512, device="cpu",
                               limits=BatchLimits(cap=100_000),
                               prefix_sharing=True)
    core = engine.core
    core.tracer = engine.executor.tracer = tracer
    first = {}
    core.on_batch = lambda event, batch, result: [
        first.setdefault(r.req_id, event.start) for r in batch.prefill_requests]
    rqs = sorted(copy.deepcopy(trace_rqs), key=lambda rq: rq.arrival_time)
    admitted, at = {}, {}
    now, i = 0.0, 0
    while i < len(rqs) or core.has_work():
        while i < len(rqs) and rqs[i].arrival_time <= now:
            core.admit(rqs[i], now)
            admitted.update((r.req_id, now) for r in rqs[i].requests)
            i += 1
        at[core.iterations] = now
        core.tick(now)
        now += 0.01
    streams = [tuple(r.output_tokens) for rq in rqs for r in rq.requests]
    return streams, admitted, first, at


@functools.lru_cache(maxsize=None)
def _traced():
    from repro_torch.engine import trace

    tracer = trace.Tracer()
    streams, admitted, first, at = _traced_serve(tracer)
    return streams, admitted, first, at, tracer.take()


def test_untraced_serve_reads_no_tracer_clock_and_calls_no_record_function(
        monkeypatch):
    from repro_torch.engine import trace

    calls = {"clock": 0, "record_function": 0}
    clock = trace._clock

    def counted_clock():
        calls["clock"] += 1
        return clock()

    def counted(real):
        def record_function(*a, **k):
            calls["record_function"] += 1
            return real(*a, **k)
        return record_function

    monkeypatch.setattr(trace, "_clock", counted_clock)
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted(torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted(torch.autograd.profiler.record_function))
    streams, *_ = _traced_serve(None)
    assert calls == {"clock": 0, "record_function": 0}
    traced, *_ = _traced_serve(trace.Tracer())
    assert calls["clock"] > 0 and calls["record_function"] == 0
    assert streams == traced == _traced()[0]


def _children(spans, parent):
    return [s for s in spans if s.parent is parent]


def test_every_tick_holds_its_children_nested_with_its_batch_id():
    *_, at, records = _traced()
    spans = records.spans
    ticks = [s for s in spans if s.name == "tick"]
    assert [t.batch for t in ticks] == list(range(len(ticks))) == sorted(at)
    for t in ticks:
        names = [c.name for c in _children(spans, t)]
        assert set(names) == _TICK_CHILDREN and len(names) == len(_TICK_CHILDREN)
        assert {"kind", "prefill", "decode", "uncached_tokens",
                "device_prefill_ms", "device_decode_ms"} <= set(t.attrs)
        # on the CPU no step is timed by CUDA events
        assert t.attrs["device_prefill_ms"] is t.attrs["device_decode_ms"] is None
        for c in _children(spans, t):
            sub = {g.name for g in _children(spans, c)}
            assert sub <= {"dispatch": _DISPATCH_CHILDREN,
                           "wait": _WAIT_CHILDREN}.get(c.name, set())
    for s in spans:
        if s.parent is not None:
            p = s.parent
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.batch == p.batch
    assert {s.name for s in spans} >= {"prefill.prep", "decode.prep", "step.load",
                                       "step.replay", "capture", "sample",
                                       "finish", "stash"}


def test_a_batch_with_a_completed_prefill_and_a_decode_samples_each_phase():
    *_, records = _traced()
    spans = records.spans
    both = [t for t in spans if t.name == "tick" and t.attrs["decode"]
            and t.attrs["uncached_tokens"]]
    assert both
    for t in both:
        wait = next(c for c in _children(spans, t) if c.name == "wait")
        phases = [s.attrs["phase"] for s in _children(spans, wait)
                  if s.name == "sample"]
        assert phases.count("decode") == 1 and "prefill" in phases
        dispatch = next(c for c in _children(spans, t) if c.name == "dispatch")
        groups = sum(s.name == "step.replay" for s in _children(spans, dispatch))
        assert phases.count("prefill") == groups - 1


def test_each_request_is_queued_until_the_tick_that_first_schedules_it():
    _, admitted, first, _, records = _traced()
    assert set(records.requests) == set(admitted) == set(first)
    for rid, q in records.requests.items():
        assert (q.admit, q.scheduled) == (admitted[rid], first[rid])
        assert q.rel_id and q.admit <= q.scheduled


def test_program_spans_hold_the_profiler_interval_of_their_op():
    """Spans converted by ``offset_ns`` lie on the profiler's clock: each
    holds the ``aten::mm`` it ran around (with half a millisecond of host
    work on each side of the op)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import trace

    tracer = trace.Tracer()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracer.span("op"):
                time.sleep(5e-4)
                x @ x
                time.sleep(5e-4)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    spans = tracer.take().spans
    assert len(ops) == len(spans) == 3
    off = tracer.offset_ns
    for s, (a, b) in zip(spans, ops):
        assert s.start_ns + off <= a < b <= s.end_ns + off
        assert a - (s.start_ns + off) < 5e6      # within 5 ms, not a clock apart
