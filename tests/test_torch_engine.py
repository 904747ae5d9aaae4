"""The slice as a whole: the port's serving engine against the JAX package's,
and the port's own equivalence pins.

- The same trace, in float32 on the smoke configs, through the JAX
  ``build_real_engine(..., "paged")`` and the port's
  ``build_real_engine(..., device="cpu")`` yields identical token streams.
- Inside the port: dense == paged, serial == pipelined, preemption and the
  host swap tier keep the streams, the paged pool drains, the fitted cost
  model has non-negative betas, and an over-long request is refused.
"""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.priority import BatchLimits as JaxBatchLimits  # noqa: E402
from repro.data.datasets import make_dataset as jax_make_dataset  # noqa: E402
from repro.data.trace import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.data.trace import build_trace as jax_build_trace  # noqa: E402
from repro.engine.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving import build_real_engine as jax_build_real_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.latency_model import a100_opt13b  # noqa: E402
from repro_torch.core.policies import SCHEDULERS  # noqa: E402
from repro_torch.core.priority import BatchLimits  # noqa: E402
from repro_torch.core.relquery import make_relquery  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.engine.engine import EngineCore  # noqa: E402
from repro_torch.engine.executor import (RequestCapacityError,  # noqa: E402
                                         make_real_executor)
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import build_real_engine  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-0.5b"]
TRACE = dict(num_relqueries=3, rate=100.0, seed=4, max_requests=4,
             output_token_cap=8)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """JAX and port models in float32 on the same weights."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jp = jm.init_params(jax.random.PRNGKey(0))
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


@pytest.mark.parametrize("arch", ARCHS)
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
    _, _, tm, tp = _models("qwen3-1.7b")
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
