"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; none catches its own):
  1. device  — CUDA with compute capability >= 9.0; card name and power limit
  2. build   — nvcc builds both attention kernels from src/repro_torch/kernels/
               csrc/ for sm_90a; prints ptxas' registers / shared memory / spills
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               at main-path shapes, bf16 and f32, TF32 off; each bf16 output
               also within half a bf16 ulp of the plain version's f32 result
  4. model   — full-width qwen3-1.7b (28 layers, bf16, random weights from a
               seed): one prefill batch and one paged decode step, kernels vs
               the plain attention path
  5. serve   — the paged engine with the paper's scheduler serving a rotten
               trace on full-width qwen3-1.7b, serial then pipelined loop; the
               launch counters must rise during this run
  6. times   — each kernel, its plain version and (flash_prefill only) torch's
               SDPA timed with CUDA events, beside the least time the card could
               take (bytes / 3.35 TB/s, flops / 989 TFLOP/s)
  7. profile — one more serial serve under torch.profiler: the device's busy
               share of the wall time and the kernels that take it
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import build_real_engine  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
# tolerances of tests/test_kernels.py: f32 1e-5; bf16 2e-2 (paged), 3e-2 (prefill)
TOL = {("paged_attention", torch.float32): 1e-5,
       ("paged_attention", torch.bfloat16): 2e-2,
       ("flash_prefill", torch.float32): 1e-5,
       ("flash_prefill", torch.bfloat16): 3e-2}
# A bf16 kernel computes in f32 and rounds once, so its output lies within half
# a bf16 ulp (<= 2^-8 |x|) of the plain version's f32 result, plus the f32
# tolerance twice over for the two summation orders. This catches a kernel that
# truncates or rounds a partial result to bf16, which the bf16 limits above
# (about 30% of a typical output) would let pass.
BF16_HALF_ULP = 2.0 ** -8
# full-model bf16 logits, kernels vs plain attention: relative to the largest
# |logit|. bf16 keeps 8 mantissa bits (3.9e-3 relative per rounding); the plain
# prefill rounds softmax weights to bf16 before PV while the kernel keeps them
# in f32, and those differences pass through 28 residual layers.
MODEL_REL_TOL = 5e-2

SOURCES = {"paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "flash_prefill": "src/repro_torch/kernels/csrc/flash_prefill.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:78",
            "flash_prefill": "src/repro/kernels/flash_prefill.py:75"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name: str, out, want, dtype, label: str) -> float:
    tol = TOL[(name, dtype)]
    err = max_err(out, want)
    bound = float((tol + tol * want.float().abs()).max())
    ok = bool(((out.float() - want.float()).abs()
               <= tol + tol * want.float().abs()).all())
    log(f"  {name} {label} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e} "
        f"(atol = rtol = {tol:g}; largest allowed {bound:.3e})")
    check(ok, f"{name} {label} {dtype}: kernel disagrees with its plain version")
    return err


def assert_rounded_once(name: str, out, want32, label: str) -> None:
    lim = BF16_HALF_ULP * want32.abs() + 2 * TOL[(name, torch.float32)]
    worst = float(((out.float() - want32).abs() / lim).max())
    log(f"  {name} {label} bfloat16 vs f32 result: worst error {worst:.3f} of "
        f"half a bf16 ulp + {2 * TOL[(name, torch.float32)]:g}")
    check(worst <= 1.0, f"{name} {label}: bf16 output is not the f32 result "
          f"rounded once")


def upcast(args):
    return [a.float() if a.is_floating_point() else a for a in args]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# inputs at main-path shapes
# ----------------------------------------------------------------------------
def paged_inputs(dtype, *, num_q_tokens=1, B=32, KV=8, Qp=2, hd=128, page=16,
                 num_pages=4097, max_pages=64, seed=1):
    """Decode-step inputs at qwen3-1.7b's widths and the serve pool's
    geometry: ragged contexts up to 1024 tokens, fragmented block tables."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rows = num_q_tokens * Qp
    q = torch.randn((B, KV, rows, hd), generator=g, device=dev).to(dtype)
    kp = torch.randn((num_pages, page, KV, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((num_pages, page, KV, hd), generator=g, device=dev).to(dtype)
    rng = np.random.RandomState(seed)
    bt = rng.permutation(num_pages)[: B * max_pages].reshape(B, max_pages)
    ctx = rng.randint(num_q_tokens, page * max_pages + 1, size=(B,))
    ctx[0], ctx[1] = page * max_pages, max(num_q_tokens, 1)   # both extremes
    return (q, kp, vp, torch.as_tensor(bt, dtype=torch.int32, device=dev),
            torch.as_tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(dtype, *, B=4, G=8, S=512, R=2, hd=128, T=512, seed=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, G, S, R, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, G, T, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, G, T, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


PREFILL_CASES = [   # (label, shape kwargs, causal, window, q_offset)
    ("causal [4,8,512,2,128]", {}, True, 0, 0),
    ("window 128", {}, True, 128, 0),
    ("q_offset 256", {"S": 256}, True, 0, 256),
    ("non-causal", {}, False, 0, 0),
]


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------
def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on an NVIDIA Hopper card")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    check(cap >= (9, 0), f"{name} has compute capability {cap}; need >= 9.0")
    log(f"[device] {name}  capability {cap}  count {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f}s "
        f"(flags: {' '.join(build.NVCC_FLAGS)})")
    for b in built.values():
        log(f"[build] {b.name}: {b.path.relative_to(build.BUILD_DIR.parents[1])} "
            f"({b.seconds:.2f}s)")
        for line in b.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"[build]   {line.strip()}")


def phase_kernels() -> dict:
    """Kernel vs plain on the card. Returns the bf16 main-path errors."""
    errs = {}
    log("[kernels] paged_attention vs paged_attention_ref")
    for dtype in (torch.bfloat16, torch.float32):
        for qt in (1, 4):
            args = paged_inputs(dtype, num_q_tokens=qt)
            out = ops.paged_attention(*args, num_q_tokens=qt)
            want = ref.paged_attention_ref(*args, num_q_tokens=qt)
            torch.cuda.synchronize()
            label = f"B=32 ctx<=1024 Qt={qt}"
            e = assert_close("paged_attention", out, want, dtype, label)
            if dtype == torch.bfloat16:
                want32 = ref.paged_attention_ref(*upcast(args), num_q_tokens=qt)
                assert_rounded_once("paged_attention", out, want32, label)
                if qt == 1:
                    errs["paged_attention"] = e
    log("[kernels] flash_prefill vs flash_prefill_ref")
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, causal, window, qoff in PREFILL_CASES:
            q, k, v = prefill_inputs(dtype, **shape)
            out = ops.flash_prefill(q, k, v, causal=causal, window=window,
                                    q_offset=qoff)
            want = ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                         q_offset=qoff)
            torch.cuda.synchronize()
            e = assert_close("flash_prefill", out, want, dtype, label)
            if dtype == torch.bfloat16:
                want32 = ref.flash_prefill_ref(*upcast((q, k, v)), causal=causal,
                                               window=window, q_offset=qoff)
                assert_rounded_once("flash_prefill", out, want32, label)
                if label.startswith("causal"):
                    errs["flash_prefill"] = e
        # the model's layout: movedim views of [B, S, G, R, hd] projections
        q, k, v = prefill_inputs(dtype)
        qs = q.movedim(2, 1).contiguous().movedim(1, 2)
        ks = k.movedim(2, 1).contiguous().movedim(1, 2)
        vs = v.movedim(2, 1).contiguous().movedim(1, 2)
        check(not qs.is_contiguous(), "strided case is not strided")
        out = ops.flash_prefill(qs, ks, vs, causal=True)
        want = ref.flash_prefill_ref(q, k, v, causal=True)
        assert_close("flash_prefill", out, want, dtype, "strided views")
    return errs


def full_model(device="cuda"):
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(SEED))
    return cfg, model, params


def phase_model(cfg, model, params, device="cuda") -> None:
    """One prefill batch and one paged decode step of the full-width model,
    kernel attention vs the plain attention path, on the same inputs."""
    B, L, bs = 4, 128, 16
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, L)),
                           dtype=torch.int32, device=device)
    # the decode step writes position seq_len, which must stay inside the
    # L // bs blocks of each table
    seq_lens = torch.as_tensor([120, 97, 64, 33], dtype=torch.int32, device=device)
    lg_plain, caches = model.with_prefill_attn("block").prefill(
        params, toks, seq_lens=seq_lens, max_len=L)
    lg_kern, _ = model.with_prefill_attn("flash").prefill(
        params, toks, seq_lens=seq_lens, max_len=L)
    scale = float(lg_plain.float().abs().max())
    err = max_err(lg_kern, lg_plain)
    same = float((lg_kern.argmax(-1) == lg_plain.argmax(-1)).float().mean())
    log(f"[model] prefill B={B} L={L}: logits max_abs_err {err:.3e} "
        f"(max |logit| {scale:.3e}, rel {err / scale:.3e}, tol {MODEL_REL_TOL:g}); "
        f"argmax agreement {same:.2f}")
    check(bool(torch.isfinite(lg_kern.float()).all()), "non-finite prefill logits")
    check(err <= MODEL_REL_TOL * scale, "prefill logits: flash vs block disagree")

    nblk = L // bs
    pools = model.init_paged_pools(B * nblk + 1, bs, device)
    tables = torch.arange(B * nblk, dtype=torch.int32, device=device).reshape(B, nblk)
    model.scatter_prefill_pools(pools, caches, tables)
    pools_ref = {k: v.clone() for k, v in pools.items()}
    tokens = lg_plain.argmax(-1).to(torch.int32)
    positions = seq_lens.clone()
    ctx = positions + 1
    d_kern, _ = model.decode_step_paged(params, pools, tokens, positions, tables,
                                        ctx, attn_impl="kernel")
    d_plain, _ = model.decode_step_paged(params, pools_ref, tokens, positions,
                                         tables, ctx, attn_impl="ref")
    scale = float(d_plain.float().abs().max())
    err = max_err(d_kern, d_plain)
    same = float((d_kern.argmax(-1) == d_plain.argmax(-1)).float().mean())
    log(f"[model] paged decode B={B}: logits max_abs_err {err:.3e} "
        f"(max |logit| {scale:.3e}, rel {err / scale:.3e}, tol {MODEL_REL_TOL:g}); "
        f"argmax agreement {same:.2f}")
    check(bool(torch.isfinite(d_kern.float()).all()), "non-finite decode logits")
    check(err <= MODEL_REL_TOL * scale, "decode logits: kernel vs ref disagree")


def serve_trace(vocab_size: int = 151934):
    tok = HashTokenizer(vocab_size=vocab_size)
    ds = make_dataset("rotten", num_rows=1000, seed=SEED)
    return build_trace(ds, TraceConfig(num_relqueries=8, rate=4.0, seed=SEED,
                                       max_requests=8, output_token_cap=16),
                       tokenizer=tok)


def run_serve(model, params, trace, loop: str, device="cuda", card: str = ""):
    trace = copy.deepcopy(trace)
    engine = build_real_engine("qwen3-1.7b", "relserve", "paged", model=model,
                               params=params, max_slots=64, max_len=1024,
                               engine_loop=loop, device=device)
    ex = engine.executor
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    report = engine.run_trace(trace)
    sync()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output_tokens) for rq in trace for r in rq.requests)
    check(sorted(report.latencies) == sorted(rq.rel_id for rq in trace),
          f"{loop}: not every relQuery finished")
    for rq in trace:
        for r in rq.requests:
            check(1 <= len(r.output_tokens) <= r.max_output_tokens,
                  f"{loop}: {r.req_id} emitted {len(r.output_tokens)} tokens")
    ex.bm.check_invariants()
    check(ex.bm.free_blocks == ex.bm.num_blocks and ex.kv_tokens_resident() == 0,
          f"{loop}: the paged pool did not drain")
    fitted = ex.fitted_model()
    log(f"[serve] {loop}: {len(report.latencies)} relQueries, "
        f"{sum(len(rq.requests) for rq in trace)} requests, {n_tok} tokens; "
        f"latency avg {report.avg_latency:.4f}s p50 {report.percentile(50):.4f}s "
        f"p99 {report.percentile(99):.4f}s; wall {wall:.3f}s, "
        f"{n_tok / wall:.1f} tokens/s; {len(report.events)} batches; "
        f"pool {ex.num_blocks + 1} blocks; fitted alpha_p {fitted.alpha_p:.3e} "
        f"beta_p {fitted.beta_p:.3e} alpha_d {fitted.alpha_d:.3e} "
        f"beta_d {fitted.beta_d:.3e}; {card}")
    streams = [tuple(r.output_tokens) for rq in trace for r in rq.requests]
    del engine, ex
    if device == "cuda":
        torch.cuda.empty_cache()
    return streams


def phase_serve(model, params) -> dict:
    card = nvidia_smi_line()
    trace = serve_trace()
    ops.reset_launch_counts()
    serial = run_serve(model, params, trace, "serial", card=card)
    after_serial = ops.launch_counts()
    pipelined = run_serve(model, params, trace, "pipelined", card=card)
    counts = ops.launch_counts()
    log(f"[serve] launches: serial {after_serial}, serial + pipelined {counts}")
    for name in build.KERNELS:
        check(after_serial[name] > 0, f"serial serve never launched {name}")
        check(counts[name] > after_serial[name],
              f"pipelined serve never launched {name}")
    same = sum(a == b for a, b in zip(serial, pipelined)) / len(serial)
    log(f"[serve] identical streams serial vs pipelined: {same:.3f} "
        f"({card})")
    return counts


def phase_times(errs: dict, counts: dict) -> list:
    dt = torch.bfloat16
    esize = 2
    out = []

    # paged_attention at the decode inputs of phase 3
    args = paged_inputs(dt)
    q, kp, vp, bt, cl = args
    B, KV, rows, hd = q.shape
    page = kp.shape[1]
    ctx = cl.long().cpu()
    tokens = int(ctx.sum())
    pages_read = int(((ctx + page - 1) // page).sum())
    nbytes = (2 * q.numel() * esize            # q read, out written
              + 2 * tokens * KV * hd * esize   # K and V of every context token
              + pages_read * 4 + B * 4)        # block-table entries, lengths
    flops = 4 * rows * hd * tokens * KV
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    ms = cuda_time_ms(lambda: ops.paged_attention(*args))
    plain = cuda_time_ms(lambda: ref.paged_attention_ref(*args))
    log(f"[times] paged_attention B={B} tokens={tokens}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bound:.4f} ms (bytes {nbytes}), "
        f"library null")
    out.append({"name": "paged_attention", "route": "cuda",
                "source": SOURCES["paged_attention"],
                "replaces": REPLACES["paged_attention"],
                "launches": counts["paged_attention"],
                "max_abs_err": errs["paged_attention"], "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": None})

    # flash_prefill at the causal main-path inputs of phase 3
    q, k, v = prefill_inputs(dt)
    B, G, S, R, hd = q.shape
    T = k.shape[2]
    pairs = sum(min(T, s + 1) for s in range(S)) * R * B * G   # unmasked (row, key)
    flops = 4 * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    ms = cuda_time_ms(lambda: ops.flash_prefill(q, k, v, causal=True))
    plain = cuda_time_ms(lambda: ref.flash_prefill_ref(q, k, v, causal=True))
    qh = q.permute(0, 1, 3, 2, 4).reshape(B, G * R, S, hd)   # head g*R + r
    lib = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, k, v, is_causal=True, enable_gqa=True))
    log(f"[times] flash_prefill q={list(q.shape)} causal: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms "
        f"(flops {flops}, bytes {nbytes})")
    out.append({"name": "flash_prefill", "route": "cuda",
                "source": SOURCES["flash_prefill"],
                "replaces": REPLACES["flash_prefill"],
                "launches": counts["flash_prefill"],
                "max_abs_err": errs["flash_prefill"], "ms": ms,
                "plain_ms": plain, "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib})
    return out


def phase_profile(model, params, device="cuda") -> None:
    """Where the serve phase's time goes: one more serial serve of the same
    trace under torch.profiler (after the launch counters were read). Prints
    the device's busy and idle share of the wall time and the kernels that
    take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    trace = serve_trace(model.cfg.vocab_size - 2)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_serve(model, params, trace, "serial", device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("[profile] the profiler recorded no device time: not measured")
        return
    launches = sum(e.count for e in kernels)
    log(f"[profile] serial serve under the profiler: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of wall, "
        f"idle {1 - busy_us / wall_us:.3f}), {launches} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f}  x{e.count:<6d} "
            f"{e.key[:90]}")


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    errs = phase_kernels()
    cfg, model, params = full_model()
    log(f"[model] {cfg.name}: {model.param_count() / 1e9:.3f}B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}")
    phase_model(cfg, model, params)
    counts = phase_serve(model, params)
    kernels = phase_times(errs, counts)
    phase_profile(model, params)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
