"""The slice as a whole: the port's serving engine against the JAX package's,
and the port's own equivalence pins.

- The same trace, in float32 on the smoke configs, through the JAX
  ``build_real_engine(..., "paged")`` and the port's
  ``build_real_engine(..., device="cpu")`` yields identical token streams.
- Inside the port: dense == paged, serial == pipelined, preemption and the
  host swap tier keep the streams, the paged pool drains, the fitted cost
  model has non-negative betas, and an over-long request is refused.
- The MoE family and gemma3: the port's greedy streams equal the JAX
  engine's (granite-moe and qwen3-moe on the paged engine, gemma3 on the
  dense one, which is the only one it takes, as in the reference); the MoE
  smoke configs keep dense == paged == pipelined (their capacity factor
  equals the expert count, so nothing drops); the CLI serves each new arch.
- rwkv6-7b on the dense engine: streams equal a one-request-at-a-time
  greedy oracle of the JAX model; serial == pipelined; a swap round trip
  with ``max_slots == num_layers``; the paged backend is refused; the CLI
  runs.
- hymba-1.5b on the dense engine: streams equal the JAX engine's on a
  trace whose prefills all come before the first decode; serial ==
  pipelined; a swap round trip; the paged backend is refused. whisper-base
  has no engine path. ``launch/train.py`` trains and resumes on the CPU.
- The one place the port departs from the reference executor: a request
  prefilled in a batch that also decodes keeps its post-prefill state in the
  port, and not in the JAX ``RealExecutor`` (rwkv6 and hymba).
- The simulator, router, cluster, autoscaler, snapshot codec and planner:
  each scenario built in both packages from the seed gives reports equal
  field for field (host-timed fields aside) and the same streams; snapshot
  JSON is byte-equal and a JAX snapshot runs on in a port scheduler.
- The planned, prefix-shared, KV-tiered paged serve of ``chip_smoke.py``
  phase 7 at the smoke config in f32: the port's streams equal the JAX
  engine's planned streams and its own unplanned ones.
- ``launch/serve.py``: the port refuses what the reference refuses, with the
  same message, and ``--simulate`` prints the reference's lines.
"""
import copy
import dataclasses
import enum
import functools
import importlib
import itertools
import json
import math
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.batch import Batch as JaxBatch  # noqa: E402
from repro.core.priority import BatchLimits as JaxBatchLimits  # noqa: E402
from repro.data.datasets import make_dataset as jax_make_dataset  # noqa: E402
from repro.data.trace import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.core.relquery import make_relquery as jax_make_relquery  # noqa: E402
from repro.data.trace import build_trace as jax_build_trace  # noqa: E402
from repro.engine.executor import RealExecutor as JaxRealExecutor  # noqa: E402
from repro.engine.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving import build_real_engine as jax_build_real_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.batch import Batch  # noqa: E402
from repro_torch.core.latency_model import a100_opt13b  # noqa: E402
from repro_torch.core.policies import SCHEDULERS  # noqa: E402
from repro_torch.core.priority import BatchLimits  # noqa: E402
from repro_torch.core.relquery import make_relquery  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.engine.engine import EngineCore  # noqa: E402
from repro_torch.engine.executor import (RealExecutor,  # noqa: E402
                                         RequestCapacityError, _bucket,
                                         make_real_executor)
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import ROUTER_POLICIES, build_real_engine  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-0.5b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
GEMMA = "gemma3-12b"
RWKV = "rwkv6-7b"
TRACE = dict(num_relqueries=3, rate=100.0, seed=4, max_requests=4,
             output_token_cap=8)
# zero-initialised RWKV6 params that get random values, so every path does work
RWKV_NOISE = ("ln1_b", "ln2_b", "mu_base", "mu", "lora_b", "w0", "wd2", "bonus",
              "mu_ck", "mu_cr")


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """JAX and port models in float32 on the same weights."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    if arch == RWKV:
        rng = np.random.RandomState(4)
        blocks = dict(jp["blocks"])
        for name in RWKV_NOISE:
            noise = 0.3 * rng.randn(*blocks[name].shape).astype(np.float32)
            blocks[name] = jnp.asarray(noise)
        jp = dict(jp, blocks=blocks)
    tm = build_model(get_smoke_config(arch).replace(dtype="float32"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _trace(cfg, **kw):
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    ds = make_dataset("beer", num_rows=64, seed=1)
    return build_trace(ds, TraceConfig(**dict(TRACE, **kw)), tokenizer=tok)


def _streams(trace):
    return [tuple(r.output_tokens) for rq in trace for r in rq.requests]


def _run(arch, backend, trace, **kw):
    _, _, tm, tp = _models(arch)
    trace = copy.deepcopy(trace)
    kw.setdefault("limits", BatchLimits(cap=100_000))
    engine = build_real_engine(arch, "relserve", backend, model=tm, params=tp,
                               max_len=512, device="cpu", **kw)
    report = engine.run_trace(trace)
    assert len(report.latencies) == len(trace)
    return _streams(trace), engine


@pytest.mark.parametrize("arch", ARCHS)
def test_port_streams_match_jax_paged_engine(arch):
    jm, jp, _, _ = _models(arch)
    cfg = jax_smoke_config(arch)
    jtrace = jax_build_trace(
        jax_make_dataset("beer", num_rows=64, seed=1), JaxTraceConfig(**TRACE),
        tokenizer=JaxHashTokenizer(vocab_size=cfg.vocab_size - 2))
    jengine = jax_build_real_engine(arch, "relserve", "paged", model=jm,
                                    params=jp, max_len=512,
                                    limits=JaxBatchLimits(cap=100_000))
    jengine.run_trace(jtrace)
    port, _ = _run(arch, "paged", _trace(get_smoke_config(arch)))
    assert port == _streams(jtrace)


@pytest.mark.parametrize("arch,backend", [(a, "paged") for a in MOE_ARCHS]
                         + [(GEMMA, "dense")])
def test_port_streams_match_jax_engine_moe_and_gemma3(arch, backend):
    """Greedy streams of the smoke configs in float32: the MoE archs on the
    paged engine, gemma3 (prompts past its 8-token window) on the dense
    engine, against the JAX engine on the same backend."""
    jm, jp, _, _ = _models(arch)
    cfg = jax_smoke_config(arch)
    jtrace = jax_build_trace(
        jax_make_dataset("beer", num_rows=64, seed=1), JaxTraceConfig(**TRACE),
        tokenizer=JaxHashTokenizer(vocab_size=cfg.vocab_size - 2))
    jengine = jax_build_real_engine(arch, "relserve", backend, model=jm,
                                    params=jp, max_len=512,
                                    limits=JaxBatchLimits(cap=100_000))
    jengine.run_trace(jtrace)
    port, _ = _run(arch, backend, _trace(get_smoke_config(arch)))
    assert port == _streams(jtrace)
    assert max(r.num_prompt_tokens for rq in jtrace for r in rq.requests) \
        > cfg.sliding_window


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_dense_paged_serial_pipelined_identical(arch):
    trace = _trace(get_smoke_config(arch))
    runs = {}
    for backend in ("dense", "paged"):
        for loop in ("serial", "pipelined"):
            runs[backend, loop], engine = _run(arch, backend, trace,
                                               engine_loop=loop)
            if backend == "paged":
                ex = engine.executor
                ex.bm.check_invariants()
                assert ex.bm.free_blocks == ex.bm.num_blocks
                assert ex.kv_tokens_resident() == 0
            fitted = engine.executor.fitted_model()
            assert fitted.beta_p >= 0 and fitted.beta_d >= 0
    assert len(set(map(tuple, runs.values()))) == 1, runs


@pytest.mark.parametrize("prefix_sharing", [False, True])
def test_preemption_keeps_streams(prefix_sharing):
    """Optimistic admission under a cap tight enough to preempt: both
    backends keep the uncapped streams and the paged pool drains."""
    arch = "qwen3-1.7b"
    cfg = get_smoke_config(arch)
    # every relQuery arrives at once: the engine clock advances by measured
    # batch times, and staggered arrivals would let a fast host finish one
    # relQuery before the next arrives, so the cap would never be reached
    trace = _trace(cfg, num_relqueries=4, output_token_cap=32, rate=1e9,
                   num_templates=1 if prefix_sharing else None)
    block = 8 if prefix_sharing else 16
    free, _ = _run(arch, "paged", trace, block_size=block)
    max_fp = max(r.num_prompt_tokens + r.max_output_tokens
                 for rq in trace for r in rq.requests)
    cap = int(max_fp * (2.5 if prefix_sharing else 1.02))
    for backend in ("dense", "paged"):
        streams, engine = _run(arch, backend, trace, kv_admission="optimistic",
                               limits=BatchLimits(cap=cap),
                               prefix_sharing=prefix_sharing, block_size=block)
        assert streams == free
        assert engine.core.scheduler.preemptions > 0
        if backend == "paged":
            ex = engine.executor
            ex.bm.check_invariants()
            assert ex.bm.free_blocks == ex.bm.num_blocks
            if prefix_sharing:
                assert ex.shared_block_hits > 0


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_swap_roundtrip_preserves_stream(backend):
    """A forced device -> host -> device round trip continues the exact
    greedy stream of an undisturbed run."""
    _swap_roundtrip("qwen3-1.7b", backend)


@pytest.mark.parametrize("arch,backend", [(MOE_ARCHS[0], "dense"),
                                          (MOE_ARCHS[0], "paged"),
                                          (GEMMA, "dense")])
def test_swap_roundtrip_preserves_stream_moe_and_gemma3(arch, backend):
    """The same round trip on granite-moe and on gemma3, whose window rings
    (``k_win``/``v_win``) go to the host and back with the full caches and
    wrap while the request decodes past its 8-token window."""
    _swap_roundtrip(arch, backend)


def _swap_roundtrip(arch, backend):
    _, _, tm, tp = _models(arch)
    tok = HashTokenizer(vocab_size=tm.cfg.vocab_size - 2)
    prompts = [tok.encode(f"row {i} of the relational table") for i in range(2)]

    def run(force_swap):
        rq = make_relquery("A", [list(p) for p in prompts], 0.0, 8)
        sched = SCHEDULERS["relserve"](
            limits=BatchLimits(cap=4096), latency_model=a100_opt13b(),
            kv_admission="optimistic", kv_tiering=True, host_kv_cap=100_000)
        ex = make_real_executor(backend, tm, tp, max_slots=8, max_len=256,
                                num_blocks=128, block_size=16,
                                num_host_blocks=128)
        core = EngineCore(sched, ex, debug_invariants=True)
        core.admit(rq, 0.0)
        now, steps = 0.0, 0
        while core.has_work():
            now = core.tick(now).end
            steps += 1
            if force_swap and steps == 2 and sched._running:
                sched.swap_out_request(sched._running[-1], now)
                core._apply_swaps()
        assert rq.is_finished()
        return sched, [list(r.output_tokens) for r in rq.requests]

    base_sched, base = run(False)
    swap_sched, swapped = run(True)
    assert base_sched.swap_outs == 0
    assert swap_sched.swap_outs >= 1
    assert swap_sched.swap_ins == swap_sched.swap_outs
    assert swapped == base


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_overlong_request_is_refused_at_admission(backend):
    _, _, tm, tp = _models("qwen3-1.7b")
    engine = build_real_engine("qwen3-1.7b", "relserve", backend, model=tm,
                               params=tp, max_len=64, device="cpu")
    rq = make_relquery("long", [[5] * 60], 0.0, 16)
    with pytest.raises(RequestCapacityError):
        engine.core.admit(rq, 0.0)


# ----------------------------------------------------------------------------
# rwkv6-7b on the dense engine
# ----------------------------------------------------------------------------
def _jax_oracle_stream(jm, jp, prompt, max_out, eos, *, max_len, max_slots):
    """Greedy decode of one request alone on the JAX model: the executor's
    bucketed pad-masked prefill, then decode steps with the live row padded
    to ``max_slots`` rows."""
    n = len(prompt)
    bucket = min(_bucket(n), max_len)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = prompt
    lg, pc = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray([n], jnp.int32),
                        max_len=max_len)
    cache = jax.tree.map(
        lambda c: jnp.zeros((c.shape[0], max_slots) + c.shape[2:], c.dtype)
        .at[:, :1].set(c), pc)
    out = [int(jnp.argmax(lg[0]))]
    while not (out[-1] == eos or len(out) >= max_out):
        tokens = np.zeros((max_slots,), np.int32)
        tokens[0] = out[-1]
        positions = np.zeros((max_slots,), np.int32)
        positions[0] = n + len(out) - 1
        lg, cache = jm.decode_step(jp, cache, jnp.asarray(tokens),
                                   jnp.asarray(positions))
        out.append(int(jnp.argmax(lg[0])))
    return tuple(out)


def test_rwkv6_dense_streams_match_jax_one_request_oracle():
    jm, jp, tm, _ = _models(RWKV)
    trace = _trace(tm.cfg)
    port, engine = _run(RWKV, "dense", trace)
    assert engine.executor.max_slots == 32
    want = [_jax_oracle_stream(jm, jp, r.tokens, r.max_output_tokens, r.eos_token,
                               max_len=512, max_slots=32)
            for rq in trace for r in rq.requests]
    assert port == want


def test_rwkv6_dense_serial_equals_pipelined():
    trace = _trace(get_smoke_config(RWKV))
    serial, _ = _run(RWKV, "dense", trace, engine_loop="serial")
    pipelined, engine = _run(RWKV, "dense", trace, engine_loop="pipelined")
    assert serial == pipelined
    fitted = engine.executor.fitted_model()
    assert fitted.beta_p >= 0 and fitted.beta_d >= 0


def test_rwkv6_swap_roundtrip_with_as_many_slots_as_layers():
    """A forced device -> host -> device round trip continues the exact
    greedy stream of an undisturbed run, with ``max_slots`` equal to the
    layer count (where a search for the slot axis by its size would take the
    layer axis of the recurrent state)."""
    _, _, tm, tp = _models(RWKV)
    n_layers = tm.cfg.num_layers
    tok = HashTokenizer(vocab_size=tm.cfg.vocab_size - 2)
    prompts = [tok.encode(f"row {i} of the relational table") for i in range(2)]

    def run(force_swap):
        rq = make_relquery("A", [list(p) for p in prompts], 0.0, 8)
        sched = SCHEDULERS["relserve"](
            limits=BatchLimits(cap=4096), latency_model=a100_opt13b(),
            kv_admission="optimistic", kv_tiering=True, host_kv_cap=100_000)
        ex = make_real_executor("dense", tm, tp, max_slots=n_layers, max_len=256)
        core = EngineCore(sched, ex, debug_invariants=True)
        core.admit(rq, 0.0)
        now, steps = 0.0, 0
        while core.has_work():
            now = core.tick(now).end
            steps += 1
            if force_swap and steps == 2 and sched._running:
                sched.swap_out_request(sched._running[-1], now)
                core._apply_swaps()
        assert rq.is_finished()
        return sched, [list(r.output_tokens) for r in rq.requests]

    base_sched, base = run(False)
    swap_sched, swapped = run(True)
    assert base_sched.swap_outs == 0
    assert swap_sched.swap_outs >= 1
    assert swap_sched.swap_ins == swap_sched.swap_outs
    assert swapped == base


def test_rwkv6_paged_backend_is_refused(monkeypatch):
    _, _, tm, tp = _models(RWKV)
    with pytest.raises(NotImplementedError, match="kv_backend='dense'"):
        build_real_engine(RWKV, "relserve", "paged", model=tm, params=tp,
                          device="cpu")
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", RWKV, "--device", "cpu",
                                      "--kv-backend", "paged"])
    with pytest.raises(SystemExit, match="--kv-backend paged"):
        serve.main()


def test_gemma3_paged_backend_is_refused_and_dense_serial_equals_pipelined(
        monkeypatch):
    """gemma3's window layers have no paged KV, as in the reference: the
    paged engine and the CLI refuse it. Its dense serial and pipelined
    serves give the same streams."""
    _, _, tm, tp = _models(GEMMA)
    with pytest.raises(NotImplementedError, match="kv_backend='dense'"):
        build_real_engine(GEMMA, "relserve", "paged", model=tm, params=tp,
                          device="cpu")
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", GEMMA, "--device",
                                      "cpu", "--kv-backend", "paged"])
    with pytest.raises(SystemExit, match="--kv-backend paged"):
        serve.main()
    trace = _trace(get_smoke_config(GEMMA))
    serial, ex = _run(GEMMA, "dense", trace)
    pipelined, _ = _run(GEMMA, "dense", trace, engine_loop="pipelined")
    assert serial == pipelined
    assert set(ex.executor.cache) == {"k_full", "v_full", "k_win", "v_win"}
    assert all(s is None for s in ex.executor.slots)


@pytest.mark.parametrize("arch,argv", [
    ("granite-moe-3b-a800m", ["--kv-backend", "paged"]),
    ("granite-moe-3b-a800m", ["--kv-backend", "paged", "--engine-loop",
                              "pipelined", "--open-loop",
                              "--num-relqueries", "4"]),
    ("granite-moe-3b-a800m", ["--kv-backend", "paged", "--plan", "full",
                              "--dup-row-fraction", "0.5"]),
    ("qwen3-moe-30b-a3b", ["--kv-backend", "paged"]),
    ("gemma3-12b", []),
    ("qwen2.5-32b", ["--kv-backend", "paged"]),
    ("internvl2-26b", []),
    ("hymba-1.5b", []),
    ("hymba-1.5b", ["--engine-loop", "pipelined"]),
])
def test_serve_cli_serves_the_new_archs_on_cpu(arch, argv, monkeypatch, capsys):
    """``--arch`` takes every new arch in real mode on the CPU: closed loop,
    open loop (pipelined) and planned."""
    code, out = _cli(_pkg("repro_torch"),
                     ["--arch", arch, "--device", "cpu", "--num-relqueries",
                      "2", "--max-requests", "2", *argv], monkeypatch, capsys)
    assert code is None
    assert "device=cpu" in out
    backend = "paged" if "paged" in argv else "dense"
    assert f"kv-backend={backend}" in out
    assert re.search(r"^\[(merged|planned|open-loop)\] ", out, re.M)


def test_serve_cli_runs_rwkv6_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", RWKV, "--device", "cpu",
                                      "--num-relqueries", "2",
                                      "--max-requests", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "kv-backend=dense" in out and "device=cpu" in out
    assert "relqueries=2" in out


def _prefill_then_mixed(ex, make_rq, batch_cls, prompts):
    """Prefill request A, then run one batch that prefills B while A decodes.
    Returns (A, B)."""
    rq = make_rq("R", [list(p) for p in prompts], 0.0, 8)
    a, b = rq.requests
    _, res = ex.execute(batch_cls("prefill", prefill_requests=[a]), 0.0)
    a.output_tokens.append(res.outputs[a.req_id][0])
    a.prefilled_tokens = a.num_prompt_tokens
    ex.execute(batch_cls("mixed", prefill_requests=[b], decode_requests=[a]), 0.0)
    return a, b


def test_rwkv6_off_batch_row_keeps_its_state_unlike_the_reference():
    """The JAX dense executor decodes every occupied row, so a request
    prefilled in a batch that also decodes gets a spurious token-0 step
    folded into its recurrent state (``repro/engine/executor.py:393-400``).
    The port leaves such a row exactly at its post-prefill state."""
    jm, jp, tm, tp = _models(RWKV)
    tok = HashTokenizer(vocab_size=tm.cfg.vocab_size - 2)
    prompts = [tok.encode("first row of the table"),
               tok.encode("second row, a longer one of the same table")]
    max_slots, max_len = 4, 128

    port = RealExecutor(tm, tp, max_slots=max_slots, max_len=max_len)
    _, b = _prefill_then_mixed(port, make_relquery, Batch, prompts)
    ref_ex = JaxRealExecutor(jm, jp, max_slots=max_slots, max_len=max_len)
    _, jb = _prefill_then_mixed(ref_ex, jax_make_relquery, JaxBatch, prompts)
    slot = port._slot_of[b.req_id]
    assert ref_ex._slot_of[jb.req_id] == slot == 1

    # B's state right after its own prefill, computed alone
    n = len(prompts[1])
    toks = np.zeros((1, _bucket(n)), np.int32)
    toks[0, :n] = prompts[1]
    _, alone = tm.prefill(tp, torch.from_numpy(toks),
                          seq_lens=torch.tensor([n], dtype=torch.int32))
    for name in ("state", "tm_shift", "cm_shift"):
        assert torch.equal(port.cache[name][:, slot], alone[name][:, 0]), name
    # the reference's state for B has moved on; A's agrees with the port's
    jstate = np.asarray(ref_ex.cache["state"], np.float32)
    want = alone["state"][:, 0].numpy()
    assert np.abs(jstate[:, slot] - want).max() > 1e-2 * np.abs(want).max()
    got_a = port.cache["state"][:, 0].numpy()
    assert np.abs(got_a - jstate[:, 0]).max() < 1e-4 * np.abs(jstate[:, 0]).max()


# ----------------------------------------------------------------------------
# hymba-1.5b on the dense engine; whisper-base has no engine path; the
# training entry point
# ----------------------------------------------------------------------------
HYMBA = "hymba-1.5b"


def test_hymba_dense_streams_match_jax_engine():
    """Greedy streams of the hymba smoke config in float32 against the JAX
    dense engine, on a trace whose prefills all come before the first decode
    (one relQuery of 7 rows, all at t = 0: one prefill batch, then decode
    batches of every live row). Where a batch prefills while other rows
    wait, the port keeps the waiting rows' state and the reference does not
    (``test_hymba_off_batch_row_keeps_its_state_unlike_the_reference``)."""
    jm, jp, _, _ = _models(HYMBA)
    cfg = jax_smoke_config(HYMBA)
    tr = dict(TRACE, num_relqueries=1, max_requests=8, rate=1e9)
    jtrace = jax_build_trace(
        jax_make_dataset("beer", num_rows=64, seed=1), JaxTraceConfig(**tr),
        tokenizer=JaxHashTokenizer(vocab_size=cfg.vocab_size - 2))
    jengine = jax_build_real_engine(HYMBA, "relserve", "dense", model=jm,
                                    params=jp, max_len=512,
                                    limits=JaxBatchLimits(cap=100_000))
    jreport = jengine.run_trace(jtrace)
    kinds = [e.kind for e in jreport.events]
    assert kinds[0] == "prefill" and set(kinds[1:]) == {"decode"}
    port, engine = _run(HYMBA, "dense", _trace(get_smoke_config(HYMBA), **tr))
    assert port == _streams(jtrace) and len(port) == 7
    assert max(r.num_prompt_tokens for rq in jtrace for r in rq.requests) \
        > cfg.sliding_window
    assert set(engine.executor.cache) == {"k_win", "v_win", "conv", "ssm"}


def test_hymba_dense_serial_equals_pipelined_and_swaps_keep_streams():
    """On a trace with mixed batches (prefills beside decodes) the port's
    streams do not depend on the loop: the off-batch rule keeps every row
    exact. A forced swap of a request's window rings, conv tail and SSM
    state to the host and back continues its undisturbed stream."""
    trace = _trace(get_smoke_config(HYMBA))
    serial, engine = _run(HYMBA, "dense", trace)
    pipelined, _ = _run(HYMBA, "dense", trace, engine_loop="pipelined")
    assert serial == pipelined
    assert all(s is None for s in engine.executor.slots)
    _swap_roundtrip(HYMBA, "dense")


def test_hymba_off_batch_row_keeps_its_state_unlike_the_reference():
    """As for rwkv6: the JAX dense executor decodes every occupied row, so a
    request prefilled in a batch that also decodes gets a spurious token-0
    step folded into its conv tail and SSM state
    (``repro/engine/executor.py:393-400``). The port leaves such a row
    exactly at its post-prefill state."""
    jm, jp, tm, tp = _models(HYMBA)
    tok = HashTokenizer(vocab_size=tm.cfg.vocab_size - 2)
    prompts = [tok.encode("first row of the table"),
               tok.encode("second row, a longer one of the same table")]
    port = RealExecutor(tm, tp, max_slots=4, max_len=128)
    _, b = _prefill_then_mixed(port, make_relquery, Batch, prompts)
    ref_ex = JaxRealExecutor(jm, jp, max_slots=4, max_len=128)
    _, jb = _prefill_then_mixed(ref_ex, jax_make_relquery, JaxBatch, prompts)
    slot = port._slot_of[b.req_id]
    assert ref_ex._slot_of[jb.req_id] == slot == 1

    n = len(prompts[1])
    toks = np.zeros((1, _bucket(n)), np.int32)
    toks[0, :n] = prompts[1]
    _, alone = tm.prefill(tp, torch.from_numpy(toks),
                          seq_lens=torch.tensor([n], dtype=torch.int32),
                          max_len=128)
    for name, axis in tm.cache_slot_axes().items():
        got = port.cache[name].narrow(axis, slot, 1)
        assert torch.equal(got, alone[name]), name
    jssm = np.asarray(ref_ex.cache["ssm"], np.float32)
    want = alone["ssm"][:, 0].numpy()
    assert np.abs(jssm[:, slot] - want).max() > 1e-2 * np.abs(want).max()
    got_a = port.cache["ssm"][:, 0].numpy()
    assert np.abs(got_a - jssm[:, 0]).max() < 1e-5 * np.abs(jssm[:, 0]).max()


def test_hymba_and_whisper_refused_where_the_reference_has_no_path(monkeypatch):
    """hymba has no paged KV (ring attention + SSM state): the paged engine
    and the CLI refuse it, naming the backend. whisper-base, an
    encoder-decoder, has no engine path at all (the executors would prefill
    it without frames): both backends and the CLI refuse it."""
    from repro_torch.launch import serve

    _, _, tm, tp = _models(HYMBA)
    with pytest.raises(NotImplementedError, match="paged"):
        build_real_engine(HYMBA, "relserve", "paged", model=tm, params=tp,
                          device="cpu")
    for backend in ("dense", "paged"):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build_real_engine("whisper-base", "relserve", backend,
                              device="cpu")
    for argv in (["--arch", HYMBA, "--kv-backend", "paged"],
                 ["--arch", "whisper-base"]):
        monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", *argv])
        with pytest.raises(SystemExit, match="paged|encoder-decoder"):
            serve.main()


def test_train_cli_runs_and_resumes_on_cpu(tmp_path, monkeypatch, capsys):
    """``repro_torch.launch.train --device cpu``: 3 steps with a checkpoint
    at step 2, then a rerun to 4 steps resumes from it; the reference's
    stdout lines. Without a card and without --device it exits."""
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    outs = []
    for steps in ("3", "4"):
        monkeypatch.setattr(sys, "argv", [
            "train", "--device", "cpu", "--steps", steps, "--ckpt-dir", ck,
            "--ckpt-every", "2"])
        train.main()
        outs.append(capsys.readouterr().out)
    assert outs[0].startswith("arch=qwen3-1.7b-smoke params=")
    assert re.search(r"^step    0 loss=[0-9.]+ gnorm=[0-9.]+ ", outs[0], re.M)
    assert "  checkpointed step 2" in outs[0]
    assert "resumed from step 2" in outs[1] and "step    3 loss=" in outs[1]
    assert "  checkpointed step 4" in outs[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "1"])
    with pytest.raises(SystemExit, match="device='cpu'"):
        train.main()


# ----------------------------------------------------------------------------
# the simulator, the serving layer, the snapshot codec and the planner against
# the JAX package: the same scenario built in each package from the seed by its
# own modules; reports equal field for field except the host-timed ones
# ----------------------------------------------------------------------------
PACKAGES = ("repro", "repro_torch")
HOST_TIMED = {"dpu_time", "aba_time", "schedule_time", "schedule_retry_time",
              "overlap_hidden_time", "plan_time"}


def _pkg(root: str) -> types.SimpleNamespace:
    """The modules of one package that the scenarios below use."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        latency=mod("core.latency_model"), policies=mod("core.policies"),
        priority=mod("core.priority"), relquery=mod("core.relquery"),
        datasets=mod("data.datasets"), trace=mod("data.trace"),
        templates=mod("data.templates"), engine=mod("engine.engine"),
        prefix_cache=mod("engine.prefix_cache"),
        simulator=mod("engine.simulator"),
        ft=mod("distributed.fault_tolerance"), serving=mod("serving"),
        planner=mod("planner"), serve=mod("launch.serve"))


def _plain(x):
    """A report as plain data: dataclasses field by field (host-timed fields
    left out), enums by value, containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x) if f.name not in HOST_TIMED})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _sim_streams(trace):
    """Each row's state and stream in trace order (request ids come from a
    process-wide counter, so they differ between two traces of one run)."""
    return [(rq.rel_id, r.state.value, tuple(r.output_tokens))
            for rq in trace for r in rq.requests]


def _both(scenario, *args, **kw):
    """Run ``scenario(P, ...)`` in each package; returns the two results.
    Request ids come from a process-wide counter in each package: both start
    from 0 here, so ids (and the snapshots that carry them) line up."""
    out = []
    for root in PACKAGES:
        P = _pkg(root)
        saved = P.relquery._req_counter
        P.relquery._req_counter = itertools.count()
        try:
            out.append(scenario(P, *args, **kw))
        finally:
            P.relquery._req_counter = saved
    return out


def _sim_trace(P, seed=11, num_relqueries=20, rate=2.0, max_requests=12,
               **kw):
    ds = P.datasets.make_dataset("rotten", num_rows=2000, seed=seed)
    return P.trace.build_trace(ds, P.trace.TraceConfig(
        num_relqueries=num_relqueries, rate=rate, seed=seed,
        max_requests=max_requests, **kw))


def _sim_engine(P, scheduler, *, cap=16384, engine_loop="serial", **kw):
    lm = P.latency.a100_opt13b()
    pc = P.prefix_cache.PrefixCache(block_size=16)
    skw = dict(limits=P.priority.BatchLimits(cap=cap), latency_model=lm,
               prefix_cache=pc, **kw)
    if scheduler.startswith("relserve"):
        skw["dpu_config"] = P.priority.DPUConfig()
    sched = P.policies.SCHEDULERS[scheduler](**skw)
    ex = P.simulator.SimulatedExecutor(
        lm, prefix_cache=pc, seed=3,
        swap_bandwidth_gbps=kw.get("swap_bandwidth_gbps", 32.0))
    return P.engine.ServingEngine(sched, ex, engine_loop=engine_loop,
                                  debug_invariants=True)


def _engine_scenario(P, scheduler, engine_loop="serial"):
    trace = _sim_trace(P)
    report = _sim_engine(P, scheduler, engine_loop=engine_loop).run_trace(trace)
    return _plain(report), _sim_streams(trace)


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
def test_simulated_engine_report_equals_the_reference(scheduler):
    ref, port = _both(_engine_scenario, scheduler)
    assert port == ref
    assert len(port[0][1]["latencies"]) == 20


def test_simulated_pipelined_report_equals_the_reference_and_serial():
    ref, port = _both(_engine_scenario, "relserve", "pipelined")
    assert port == ref
    serial = _engine_scenario(_pkg("repro_torch"), "relserve")
    assert port == serial


def _tiered_scenario(P, engine_loop):
    """Tight cap, optimistic admission, host tier with proactive offload and
    swap-in prefetch on a modeled slow link, so both reclaim paths run."""
    trace = _sim_trace(P, num_relqueries=12, rate=3.0, max_requests=10)
    engine = _sim_engine(P, "relserve", cap=500, engine_loop=engine_loop,
                         kv_admission="optimistic", kv_tiering=True,
                         host_kv_cap=2000, swap_bandwidth_gbps=6.0,
                         proactive_offload=True, idle_horizon_s=1.0,
                         swap_prefetch=True)
    return _plain(engine.run_trace(trace)), _sim_streams(trace)


@pytest.mark.parametrize("engine_loop", ["serial", "pipelined"])
def test_simulated_tiering_report_equals_the_reference(engine_loop):
    ref, port = _both(_tiered_scenario, engine_loop)
    assert port == ref
    fields = port[0][1]
    assert fields["preemptions"] > 0 and fields["swap_outs"] > 0
    assert fields["swap_ins"] == fields["swap_outs"]
    assert fields["proactive_offloads"] > 0 and fields["swap_prefetches"] > 0


def _cluster_scenario(P, replicas, policy, **kw):
    trace = _sim_trace(P, num_relqueries=16, rate=3.0, max_requests=10,
                       **kw.pop("trace_kw", {}))
    cluster = P.serving.build_simulated_cluster(
        replicas, router_policy=policy, seed=7, debug_invariants=True, **kw)
    report = cluster.run_trace(trace)
    return _plain(report), _sim_streams(trace), dict(cluster.router.stats)


@pytest.mark.parametrize("policy", ROUTER_POLICIES)
@pytest.mark.parametrize("replicas", [1, 4])
def test_simulated_cluster_report_equals_the_reference(replicas, policy):
    ref, port = _both(_cluster_scenario, replicas, policy)
    assert port == ref
    assert len(port[0][1]["per_replica"]) == replicas


def test_router_policies_and_hash_routing_are_the_reference_ones():
    from repro.serving import ROUTER_POLICIES as ref_policies
    from repro.serving import route_relquery as ref_route
    from repro_torch.serving import route_relquery
    assert ROUTER_POLICIES == ref_policies
    assert [route_relquery(f"q{i}", 5) for i in range(50)] == \
        [ref_route(f"q{i}", 5) for i in range(50)]


@pytest.mark.parametrize("engine_loop", ["serial", "pipelined"])
def test_simulated_prefix_sharing_cluster_equals_the_reference(engine_loop):
    ref, port = _both(_cluster_scenario, 2, "prefix_affinity",
                      prefix_sharing=True, engine_loop=engine_loop,
                      kv_admission="optimistic",
                      trace_kw=dict(num_templates=1))
    assert port == ref
    assert port[0][1]["merged"][1]["shared_kv_tokens"] > 0


def _crash_scenario(P, snapshot_every, engine_loop):
    """A 2-replica Frontend replay; the busiest replica crashes once the
    clock passes 1.2x the last arrival and its relQueries fail over (from
    its last snapshot when ``snapshot_every`` takes them). Also returns every
    token the clients were handed, per request."""
    trace = _sim_trace(P, num_relqueries=10, rate=3.0, max_requests=12)
    cluster = P.serving.build_simulated_cluster(
        2, seed=7, engine_loop=engine_loop, snapshot_every=snapshot_every,
        debug_invariants=True)
    fe = P.serving.Frontend(cluster)
    delivered = {}
    pending = sorted(trace, key=lambda r: r.arrival_time)
    crash_at = 1.2 * pending[-1].arrival_time
    idx, crashed = 0, False
    while True:
        nxt = fe.next_step_time()
        ns = math.inf if nxt is None else nxt
        na = pending[idx].arrival_time if idx < len(pending) else math.inf
        if not crashed and min(ns, na) >= crash_at:
            victim = max(cluster.admitting_replicas(),
                         key=lambda i: (cluster.cores[i].load(), -i))
            cluster.crash_replica(victim, crash_at)
            crashed = True
            continue
        if math.isinf(ns) and math.isinf(na):
            break
        if na <= ns:
            fe.submit(pending[idx], now=na, on_token=lambda rid, tok:
                      delivered.setdefault(rid, []).append(tok))
            idx += 1
            continue
        fe.step()
    return _plain(cluster.report()), _sim_streams(trace), delivered


@pytest.mark.parametrize("engine_loop", ["serial", "pipelined"])
@pytest.mark.parametrize("snapshot_every", [0, 4])
def test_simulated_crash_failover_equals_the_reference(snapshot_every,
                                                       engine_loop):
    ref, port = _both(_crash_scenario, snapshot_every, engine_loop)
    assert port == ref
    (name, report), _, _ = port
    (event,) = report["crash_events"]
    assert event["victims"] > 0
    assert (event["from_snapshot"] > 0) == (snapshot_every > 0)
    assert report["replica_states"].count("dead") == 1


def _drain_scenario(P):
    trace = P.trace.quick_trace("beer", num_relqueries=16, rate=6.0, seed=5,
                                max_requests=10)
    cluster = P.serving.build_simulated_cluster(3, seed=7,
                                                debug_invariants=True)
    fe = P.serving.Frontend(cluster)
    pending = sorted(trace, key=lambda r: r.arrival_time)
    for rq in pending[:12]:
        fe.submit(rq, now=rq.arrival_time)
    for _ in range(8):
        fe.step()
    event = cluster.drain_replica(1, fe.clock)
    for rq in pending[12:]:
        fe.submit(rq, now=max(rq.arrival_time, fe.clock))
    fe.drain()
    return _plain(cluster.report()), _sim_streams(trace), _plain(event)


def test_simulated_drain_equals_the_reference():
    ref, port = _both(_drain_scenario)
    assert port == ref
    assert port[0][1]["replica_states"][1] == "dead"
    assert port[2]["action"] == "drain"


def _autoscale_scenario(P):
    trace = _sim_trace(P, num_relqueries=20, rate=8.0, max_requests=10)
    cluster = P.serving.build_simulated_cluster(1, seed=7,
                                                debug_invariants=True)
    auto = P.serving.Autoscaler(cluster, P.serving.AutoscaleConfig(
        min_replicas=1, max_replicas=3, scale_up_queue=4.0,
        scale_down_queue=0.5, eval_interval_s=0.25, cooldown_s=1.0))
    cluster.attach_autoscaler(auto)
    P.serving.Frontend(cluster).replay(trace)
    return (_plain(cluster.report()), _sim_streams(trace),
            _plain(auto.decisions), cluster.metrics_snapshot())


def test_simulated_autoscaler_equals_the_reference():
    ref, port = _both(_autoscale_scenario)
    assert port == ref
    assert any(d["action"] == "scale_up" for d in port[2])


def _open_loop_scenario(P, capsys):
    """The CLI's scripted open-loop session (streaming, a cancellation, a
    late submission, a live snapshot) on a 2-replica cluster."""
    trace = _sim_trace(P, num_relqueries=12, rate=3.0, max_requests=10)
    cluster = P.serving.build_simulated_cluster(2, seed=7,
                                                debug_invariants=True)
    capsys.readouterr()
    report = P.serve.run_open_loop(P.serving.Frontend(cluster), trace)
    return _plain(report), _sim_streams(trace), capsys.readouterr().out


def test_open_loop_session_on_a_cluster_equals_the_reference(capsys):
    ref, port = _both(_open_loop_scenario, capsys)
    assert port == ref
    assert "OPEN-LOOP SMOKE OK" in port[2] and "late-submitted" in port[2]
    assert len(port[0][1]["cancelled_rel_ids"]) == 1


def _stress(P, scheduler, trace):
    """A scheduler under every kind of KV pressure at once, as
    tests/test_fault_tolerance.py stresses the codec: a tight cap under
    optimistic admission, small prefill chunks, an undersized host tier."""
    lm = P.latency.a100_opt13b()
    max_fp = max(r.num_prompt_tokens + r.max_output_tokens
                 for rq in trace for r in rq.requests)
    cap = int(max_fp * 1.3)
    pc = P.prefix_cache.PrefixCache(block_size=16)
    sched = P.policies.SCHEDULERS[scheduler](
        limits=P.priority.BatchLimits(cap=cap, max_num_batched_tokens=96),
        latency_model=lm, prefix_cache=pc, kv_admission="optimistic",
        kv_tiering=True, host_kv_cap=int(0.5 * cap))
    return sched, P.simulator.SimulatedExecutor(lm, prefix_cache=pc)


def _drive_batches(sched, ex, pending, iterations, cancel_at=None):
    """Admit arrivals and run ``iterations`` batches by hand; returns the
    index of the first relQuery not yet admitted."""
    now, idx = 0.0, 0
    for it in range(iterations):
        while idx < len(pending) and pending[idx].arrival_time <= now:
            sched.add_relquery(pending[idx], now)
            idx += 1
        if it == cancel_at:
            live = [rq for rq in sched.relqueries.values()
                    if rq.finish_time is None and rq.cancel_time is None]
            sched.cancel_relquery(live[0].rel_id, now)
        batch = sched.schedule(now)
        if batch is None:
            if idx < len(pending):
                now = pending[idx].arrival_time
                continue
            break
        dur, result = ex.execute(batch, now)
        sched.complete_batch(batch, result, now, now + dur)
        now += dur
    return idx


def _codec_trace(P):
    return P.trace.quick_trace("beer", num_relqueries=8, rate=4.0, seed=3,
                               max_requests=10)


def _snapshot_scenario(P, scheduler, stop_after, cancel_at):
    trace = _codec_trace(P)
    sched, ex = _stress(P, scheduler, trace)
    pending = sorted(trace, key=lambda r: r.arrival_time)
    _drive_batches(sched, ex, pending, stop_after, cancel_at)
    return json.dumps(P.ft.snapshot_scheduler(sched), sort_keys=True)


@pytest.mark.parametrize("cancel_at", [None, 10])
@pytest.mark.parametrize("stop_after", [30, 400])
@pytest.mark.parametrize("scheduler", ["relserve", "vllm"])
def test_snapshot_json_is_byte_identical_to_the_reference(scheduler,
                                                          stop_after,
                                                          cancel_at):
    ref, port = _both(_snapshot_scenario, scheduler, stop_after, cancel_at)
    assert port == ref
    snap = json.loads(port)
    assert snap["version"] == 2 and snap["relqueries"]


def _restored_run(P, scheduler, snap_json, kv_lost):
    """Restore ``snap_json`` into a fresh scheduler of package ``P`` and
    finish the trace; the report and every row's stream."""
    trace = _codec_trace(P)
    pending = sorted(trace, key=lambda r: r.arrival_time)
    sched, ex = _stress(P, scheduler, trace)
    snap = json.loads(snap_json)
    P.ft.restore_scheduler(sched, snap, kv_lost=kv_lost)
    sched.audit_ledgers(repair=False)
    admitted = {rq["rel_id"] for rq in snap["relqueries"]}
    report = P.engine.ServingEngine(sched, ex, debug_invariants=True).run_trace(
        [rq for rq in pending if rq.rel_id not in admitted])
    streams = [(rel_id, r.req_id, r.state.value, tuple(r.output_tokens))
               for rel_id, rq in sorted(sched.relqueries.items())
               for r in rq.requests]
    return _plain(report), streams


@pytest.mark.parametrize("kv_lost", [True, False])
@pytest.mark.parametrize("scheduler", ["relserve", "vllm"])
def test_reference_snapshot_restores_into_the_port(scheduler, kv_lost):
    """A snapshot the JAX package took mid-flight, restored into a port
    scheduler, runs on to the report the JAX package reaches from it."""
    snap_json = _both(_snapshot_scenario, scheduler, 30, None)[0]
    ref, port = _both(_restored_run, scheduler, snap_json, kv_lost)
    assert port == ref
    assert all(state == "finished" for *_, state, _ in port[1])


# ----------------------------------------------------------------------------
# the planner in real mode: the planned, prefix-shared, KV-tiered paged serve
# of chip_smoke.py phase 7, at the smoke config in float32 on the CPU
# ----------------------------------------------------------------------------
PLANNED_TRACE = dict(num_relqueries=16, rate=1e9, seed=0, max_requests=8,
                     output_token_cap=32, dup_row_fraction=0.5)


def _planned_trace(trace_mod, datasets_mod, tok):
    return trace_mod.build_trace(
        datasets_mod.make_dataset("rotten", num_rows=1000, seed=0),
        trace_mod.TraceConfig(**PLANNED_TRACE), tokenizer=tok)


def _tiered_kw(trace):
    """Blocks of 8 (the templates share 13-token prefixes), a cap of three
    times the largest request footprint, a host tier of four caps and a
    modeled 8 GB/s link, so the serve shares blocks, swaps and recomputes."""
    cap = 3 * max(r.num_prompt_tokens + r.max_output_tokens
                  for rq in trace for r in rq.requests)
    return cap, dict(max_len=512, block_size=8, prefix_sharing=True,
                     kv_admission="optimistic", kv_tiering=True,
                     host_kv_cap=4 * cap, proactive_offload=True,
                     swap_prefetch=True, swap_bandwidth_gbps=8.0)


def _planned_replay(P, engine, trace, tok):
    planner = P.planner.Planner("full", tokenizer=tok)
    planned = planner.plan_trace(trace)
    report = P.planner.PlanExecutor(P.serving.Frontend(engine),
                                    planner).replay(planned)
    return report, [tuple(r.output_tokens) for p in planned
                    for r in p.logical_requests]


def test_planned_tiered_serve_matches_jax_and_the_unplanned_serve():
    jm, jp, tm, tp = _models("qwen3-1.7b")
    P, J = _pkg("repro_torch"), _pkg("repro")
    cfg = get_smoke_config("qwen3-1.7b")
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    trace = _planned_trace(P.trace, P.datasets, tok)
    cap, kw = _tiered_kw(trace)

    engine = build_real_engine("qwen3-1.7b", "relserve", "paged", model=tm,
                               params=tp, limits=BatchLimits(cap=cap),
                               device="cpu", **kw)
    report, planned = _planned_replay(P, engine, copy.deepcopy(trace), tok)
    ex = engine.executor
    assert report.deduped_requests > 0 and report.shared_kv_tokens > 0
    assert ex.shared_block_hits > 0
    assert report.preemptions > 0 and report.swap_outs > 0
    assert report.swap_ins == report.swap_outs
    ex.bm.check_invariants()
    assert ex.bm.free_blocks == ex.bm.num_blocks
    assert ex.bm.host_free_blocks == ex.bm.num_host_blocks

    unplanned_trace = copy.deepcopy(trace)
    build_real_engine("qwen3-1.7b", "relserve", "paged", model=tm, params=tp,
                      limits=BatchLimits(cap=cap), device="cpu",
                      **kw).run_trace(unplanned_trace)
    assert planned == [tuple(r.output_tokens) for rq in unplanned_trace
                       for r in rq.requests]

    jtok = JaxHashTokenizer(vocab_size=cfg.vocab_size - 2)
    jengine = jax_build_real_engine("qwen3-1.7b", "relserve", "paged",
                                    model=jm, params=jp,
                                    limits=JaxBatchLimits(cap=cap), **kw)
    jreport, jplanned = _planned_replay(
        J, jengine, _planned_trace(J.trace, J.datasets, jtok), jtok)
    assert planned == jplanned
    # every relQuery arrives at once, so the batches do not depend on the
    # measured clock: the same batches and counters, whatever the times
    assert _schedule(report) == _schedule(jreport)


def _schedule(report):
    counters = ("deduped_requests", "shared_kv_tokens", "preemptions",
                "preempted_tokens", "swap_outs", "swap_ins",
                "swapped_out_tokens", "reclaim_swap_decisions",
                "reclaim_recompute_decisions", "proactive_offloads",
                "swap_prefetches", "prefix_lookup_tokens")
    return ({c: getattr(report, c) for c in counters},
            [(e.kind, e.num_requests, e.uncached_tokens, e.rel_ids)
             for e in report.events])


def _dup_trace(P):
    ds = P.datasets.make_dataset("rotten", num_rows=2000, seed=11)
    return P.trace.build_trace(ds, P.trace.TraceConfig(
        num_relqueries=6, rate=3.0, seed=11, max_requests=12,
        num_templates=2, dup_row_fraction=0.5))


def _plans(P, mode):
    planned = P.planner.Planner(mode).plan_trace(_dup_trace(P))
    return [(p.rel_id, p.num_logical, p.num_physical, p.deduped_requests,
             p.physical is p.logical,
             [(r.req_id, tuple(r.tokens)) for r in p.logical_requests],
             [r.req_id for r in p.physical.requests],
             {k: [f.req_id for f in v] for k, v in p.fanout.items()})
            for p in planned]


@pytest.mark.parametrize("mode", ["off", "dedup", "reorder", "full"])
def test_plan_trace_equals_the_reference(mode):
    from repro.planner import PLAN_MODES as ref_modes
    from repro_torch.planner import PLAN_MODES
    assert PLAN_MODES == ref_modes
    ref, port = _both(_plans, mode)
    assert port == ref
    assert any(deduped for _, _, _, deduped, *_ in port) == \
        (mode in ("dedup", "full"))


def _planned_sim_scenario(P, scheduler, mode):
    trace = _dup_trace(P)
    engine = _sim_engine(P, scheduler, kv_admission="optimistic",
                         prefix_sharing=True)
    planner = P.planner.Planner(mode)
    planned = planner.plan_trace(trace)
    report = P.planner.PlanExecutor(P.serving.Frontend(engine),
                                    planner).replay(planned)
    return _plain(report), [(r.state.value, tuple(r.output_tokens))
                            for p in planned for r in p.logical_requests]


@pytest.mark.parametrize("mode", ["dedup", "full"])
@pytest.mark.parametrize("scheduler", ["relserve", "vllm"])
def test_simulated_planned_replay_equals_the_reference(scheduler, mode):
    ref, port = _both(_planned_sim_scenario, scheduler, mode)
    assert port == ref
    assert port[0][1]["deduped_requests"] > 0


def _dag_scenario(P):
    """A two-stage plan: the second stage's rows bind the first stage's
    decoded answers, and enter the engine when the first stage finishes."""
    classify = P.templates.RelQueryTemplate(
        "t/classify", "classify",
        "Categorize the sentiment of the review {review} as Negative , "
        "Positive , or Neutral .")
    followup = P.templates.RelQueryTemplate(
        "t/summarize", "summarize",
        "Given the sentiment {answer} summarize the review {review} "
        "within 20 words .")
    rows = [{"review": f"review body number {i % 3}",
             "extra": f"unused column {i}"} for i in range(8)]
    engine = _sim_engine(P, "relserve", kv_admission="optimistic",
                         prefix_sharing=True)
    executor = P.planner.PlanExecutor(P.serving.Frontend(engine),
                                      P.planner.Planner("full"))
    s1 = P.planner.scan("s1", rows, classify)
    plan = P.planner.QueryPlan([s1, P.planner.derive("s2", s1, followup)],
                               plan_id="dag")
    handle = executor.submit_plan(plan)
    out = {}
    for node in ("s1", "s2"):
        rq = handle.result(node)
        out[node] = (rq.arrival_time, rq.finish_time,
                     [(tuple(r.tokens), tuple(r.output_tokens))
                      for r in handle.stage(node).logical_requests])
    return out, _plain(executor.snapshot())


def test_dag_plan_equals_the_reference():
    ref, port = _both(_dag_scenario)
    assert port == ref
    stages = port[0]
    assert stages["s2"][0] >= stages["s1"][1]


# ----------------------------------------------------------------------------
# launch/serve.py: the port's CLI against the reference's
# ----------------------------------------------------------------------------
# the argument checks of tests/test_serve_cli.py::test_cli_validation, then
# those of the elastic and planner flags
CLI_REFUSALS = [
    ["--simulate", "--rate", "0"],
    ["--simulate", "--rate", "-1.5"],
    ["--simulate", "--num-relqueries", "0"],
    ["--simulate", "--max-requests", "0"],
    ["--simulate", "--num-replicas", "0"],
    ["--simulate", "--kv-tiering", "on"],
    ["--simulate", "--host-kv-cap", "4096"],
    ["--simulate", "--swap-bandwidth", "16"],
    ["--simulate", "--kv-tiering", "on", "--kv-admission", "optimistic",
     "--host-kv-cap", "0"],
    ["--simulate", "--kv-tiering", "on", "--kv-admission", "optimistic",
     "--swap-bandwidth", "0"],
    ["--simulate", "--plan", "full", "--open-loop"],
    ["--crash-at", "2.0", "--num-replicas", "2"],
    ["--simulate", "--autoscale", "--open-loop"],
    ["--simulate", "--crash-at", "2.0"],
    ["--simulate", "--crash-at", "0", "--num-replicas", "2"],
    ["--simulate", "--max-replicas", "3"],
    ["--simulate", "--snapshot-every", "-1"],
    ["--snapshot-every", "4"],
    ["--simulate", "--metrics-interval", "0"],
    ["--simulate", "--autoscale", "--num-replicas", "5", "--max-replicas",
     "4"],
    ["--simulate", "--dup-row-fraction", "1.5"],
]


def _cli(P, argv, monkeypatch, capsys):
    """``launch.serve.main`` of package ``P`` on ``argv``: (exit message or
    None, stdout)."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    try:
        P.serve.main()
        code = None
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", CLI_REFUSALS)
def test_serve_cli_refuses_as_the_reference_does(argv, monkeypatch, capsys):
    ref, port = _both(_cli, argv, monkeypatch, capsys)
    assert isinstance(port[0], str) and port[0]
    assert port == ref


HOST_TIMED_LINE = re.compile(r"^overheads:|^overlap:|plan [0-9.]+ms")


@pytest.mark.parametrize("argv", [
    ["--num-relqueries", "8", "--max-requests", "8", "--rate", "4.0"],
    ["--num-relqueries", "12", "--max-requests", "12", "--rate", "3.0",
     "--num-replicas", "4", "--crash-at", "2.0", "--debug-invariants"],
    ["--num-relqueries", "10", "--plan", "full", "--dup-row-fraction", "0.5",
     "--prefix-sharing", "on"],
])
def test_simulated_serve_cli_prints_what_the_reference_prints(
        argv, monkeypatch, capsys):
    ref, port = _both(_cli, ["--simulate", *argv], monkeypatch, capsys)
    assert ref[0] is None and port[0] is None
    lines = [[line for line in out.splitlines()
              if not HOST_TIMED_LINE.search(line)] for _, out in (ref, port)]
    assert lines[1] == lines[0]
    assert any(line.startswith(("[merged] relqueries=", "[planned] relqueries="))
               for line in lines[1])


def test_serve_cli_simulate_refuses_a_device(monkeypatch, capsys):
    code, _ = _cli(_pkg("repro_torch"), ["--simulate", "--device", "cpu"],
                   monkeypatch, capsys)
    assert "--simulate" in code and "--device" in code


def test_serve_cli_real_mode_runs_one_replica(monkeypatch, capsys):
    code, _ = _cli(_pkg("repro_torch"),
                   ["--device", "cpu", "--num-replicas", "2"],
                   monkeypatch, capsys)
    assert "use --simulate for --num-replicas > 1" in code


def test_serve_cli_plans_a_real_serve_on_cpu(monkeypatch, capsys):
    code, out = _cli(_pkg("repro_torch"),
                     ["--device", "cpu", "--kv-backend", "paged", "--plan",
                      "full", "--dup-row-fraction", "0.5",
                      "--num-relqueries", "4", "--max-requests", "4"],
                     monkeypatch, capsys)
    assert code is None
    assert "device=cpu" in out and "[planned] relqueries=4" in out
    assert "rows answered by dedup fan-out" in out


# --------------------------------------------------------------------------
# the analysis tooling: launch/{cells,hlo_stats,roofline,dryrun,mesh}.py
# --------------------------------------------------------------------------
from repro_torch.configs import ARCH_IDS, all_cells, get_config  # noqa: E402
from repro_torch.distributed.sharding import ParallelConfig  # noqa: E402
from repro_torch.launch import hlo_stats as HS  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models.registry import build_model as torch_build_model  # noqa: E402


def _production_pcs(shape):
    """Both packages' ParallelConfig of the single-pod mesh (16, 16) for a
    cell: DP dropped where the batch does not divide it (long_500k)."""
    from repro.distributed.sharding import ParallelConfig as JaxPC
    dp = 16 if shape.global_batch % 16 == 0 else 1
    kw = dict(dp_axes=("data",) if dp > 1 else (), tp_axis="model", tp=16, dp=dp)
    return JaxPC(**kw), ParallelConfig(**kw)


@pytest.mark.parametrize("arch,shape_name,supported", all_cells())
def test_analytic_terms_equal_the_reference(arch, shape_name, supported):
    """All 40 (arch, shape) cells at full width on the (16, 16) mesh:
    ``analytic_model_flops`` and ``analytic_memory_bytes`` (which read
    ``param_count()`` and ``cache_struct()``) equal the reference's, and a
    decode cell's ``cache_struct`` has the reference's keys, shapes and
    dtypes (meta tensors here). Arithmetic only: nothing is traced."""
    import repro.launch.roofline as RR
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_shape as jax_get_shape
    from repro_torch.configs import get_shape

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = get_shape(shape_name), jax_get_shape(shape_name)
    assert supported == cfg.supports_shape(shape)
    assert RL.analytic_model_flops(cfg, shape) == RR.analytic_model_flops(jcfg, jshape)
    jpc, pc = _production_pcs(shape)
    jm, tm = jax_build_model(jcfg, jpc), torch_build_model(cfg, pc)
    assert tm.param_count() == jm.param_count()
    assert RL.analytic_memory_bytes(cfg, shape, tm, 256, 16) == \
        RR.analytic_memory_bytes(jcfg, jshape, jm, 256, 16)
    if shape.is_decode:
        got = tm.cache_struct(shape.global_batch, shape.seq_len)
        want = jm.cache_struct(shape.global_batch, shape.seq_len)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k


_HLO_LINES = {   # one collective of each kind as the reference's parser reads it
    "all-reduce": "%a = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={{0,1,2,3}}",
    "all-gather": "%b = bf16[16,64]{1,0} all-gather(bf16[2,64]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7}}",
    "reduce-scatter": "%c = f32[256]{0} reduce-scatter(f32[4096]{0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}",
    "all-to-all": "%d = bf16[8,32]{1,0} all-to-all(bf16[8,32]{1,0} %x), replica_groups={{0,1}}",
    "collective-permute": "%e = f32[100]{0} collective-permute(f32[100]{0} %x), source_target_pairs={{0,1}}",
}
_RECORDS = {
    "all-reduce": HS.CollectiveRecord("all-reduce", 4096, 4, True),
    "all-gather": HS.CollectiveRecord("all-gather", 16 * 64 * 2, 8, True),
    "reduce-scatter": HS.CollectiveRecord("reduce-scatter", 1024, 16, False),
    "all-to-all": HS.CollectiveRecord("all-to-all", 8 * 32 * 2, 2, True),
    "collective-permute": HS.CollectiveRecord("collective-permute", 400, 1, True),
}


@pytest.mark.parametrize("kind", list(_HLO_LINES))
def test_wire_bytes_follow_the_reference_formula(kind):
    """``collective_stats`` on a hand-made record of each kind gives the
    reference's output bytes, wire bytes and count for the same collective
    written as HLO; ``CollectiveStats`` is the reference's (scaled, add)."""
    from repro.launch.hlo_stats import collective_stats as jax_stats
    want = jax_stats(_HLO_LINES[kind])
    got = HS.collective_stats([_RECORDS[kind]])
    assert dict(got.out_bytes) == dict(want.out_bytes)
    assert dict(got.wire_bytes) == pytest.approx(dict(want.wire_bytes))
    assert dict(got.counts) == dict(want.counts)
    both = got.add(got.scaled(2.0))
    assert both.counts[kind] == 3 and both.total_out_bytes == 3 * got.total_out_bytes


_RECORDER = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.hlo_stats import CollectiveRecorder
from repro_torch.launch.mesh import fake_world

with fake_world(16):
    mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("data", "model"))
    x = torch.zeros(4, 64)
    with CollectiveRecorder() as rec:
        dist.all_reduce(x, group=mesh.get_group("model"))      # in place, c10d
        d = DTensor.from_local(x, mesh, [Partial(), Replicate()], run_check=False)
        d.redistribute(mesh, [Shard(0), Replicate()])           # functional
        out = torch.zeros(4, 64)
        dist.all_gather_into_tensor(out, x[:2].contiguous(),
                                    group=mesh.get_group("data"))
print("RECORDS", json.dumps([r.__dict__ for r in rec.records]))
"""


def test_collective_recorder_counts_in_place_and_functional_calls():
    """On a fake world of 16 ranks as (2, 8): an in-place ``dist.all_reduce``
    over the model axis (8 ranks on rank 0's node), DTensor's
    reduce-scatter over the data axis (ranks 0 and 8: two nodes) and an
    in-place all-gather, each with its output's bytes and its group."""
    import os
    import subprocess
    from pathlib import Path

    src = str(Path(__file__).resolve().parent.parent / "src")
    proc = subprocess.run([sys.executable, "-c", _RECORDER], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RECORDS")][0]
    recs = json.loads(line.split(" ", 1)[1])
    assert recs == [
        {"kind": "all-reduce", "out_bytes": 4 * 64 * 4, "group_size": 8, "intra_node": True, "calls": 1},
        {"kind": "reduce-scatter", "out_bytes": 2 * 64 * 4, "group_size": 2, "intra_node": False, "calls": 1},
        {"kind": "all-gather", "out_bytes": 4 * 64 * 4, "group_size": 2, "intra_node": False, "calls": 1},
    ]
