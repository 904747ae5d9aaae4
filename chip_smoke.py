"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; none catches its own):
  1. device  — CUDA with compute capability >= 9.0; card name and power limit
  2. build   — nvcc builds the three kernels from src/repro_torch/kernels/csrc/
               for sm_90a, one process each, in parallel; prints ptxas'
               registers / shared memory / spills, and each library's count
               of tensor-core instructions (HMMA) in its SASS from cuobjdump
               ("not measured" without it; flash_prefill's must be > 0)
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               at main-path shapes (paged_attention also at the planned
               serve's 8-token pages), bf16 and f32, TF32 off; each bf16 output
               also within half a bf16 ulp of the plain version's f32 result.
               Which kernel serves which dtype: flash_prefill bf16 runs on
               the tensor cores (mma.sync, P split into bf16 hi + lo), f32
               on the SIMT kernel; paged_attention is one split-KV kernel
               (plus its merge launch) for both; rwkv6_chunk takes bf16 or
               f32 r/k/v with f32 state. rwkv6_chunk one chunk per launch
               at c = 16 / 32 / 64 and through strided chunk views; one
               launch per layer (every chunk of [1, 256], [1, 1024],
               [1, 4096] at c = 32, a padded row, views cut from wider
               projections, f32) against the chained plain version and
               against chained one-chunk launches; 4 chunks, chained and
               in one launch, against the sequential oracle
  Two paths follow, each driven with the launch counters set to 0 just before
  and read just after; each must launch the kernels of its own model:
  4. qwen3   — full-width qwen3-1.7b (28 layers, bf16, random weights from a
     model     seed): one prefill batch and one paged decode step, kernels vs
               the plain attention path
  5. qwen3   — the paged engine with the paper's scheduler serving a rotten
     serve     trace, serial then pipelined loop (paged_attention, flash_prefill)
  6. qwen3   — one more serial serve under torch.profiler: the device's busy
     profile   share of the wall time and the kernels that take it
  7. qwen3   — the workload planner (dedup fan-out, prefix-maximizing
     planned   reorder) in front of the paged engine with physically shared
               prefix blocks, optimistic admission at a tight KV cap,
               preemption, swaps to a host tier with proactive offload and
               prefetch; serial then pipelined. Checks every row's stream,
               the dedup fan-out, shared blocks, preemptions, swaps, both
               pools drained; reports the share of rows whose streams equal
               an unplanned serve of the same engine; then one more planned
               serial serve under torch.profiler
  8. rwkv6   — full-width rwkv6-7b (random weights from the seed), in float32
     model     at full depth (32 layers) and in bf16 at 4 layers (reported at
               32): one prefill at B=2 L=128 and one decode step from each
               cache, kernel vs plain WKV chunks, beside the plain chunks with
               their outputs perturbed by 1e-6 (the model's own sensitivity);
               and in bf16 at 32 layers each layer's time mix on its own,
               teacher-forced (output and state, kernel vs plain)
  9. rwkv6   — the dense engine serving the same trace, serial then pipelined
     serve     (rwkv6_chunk, one launch per layer per prefill call); the two
               runs' streams must be identical
 10. rwkv6   — one more serial serve under torch.profiler
     profile
 11. times   — each kernel, its plain version and (flash_prefill only) torch's
               SDPA timed on the device with CUDA events (calls queued behind
               a device-side sleep), beside the least time the card could
               take (bytes / 3.35 TB/s, flops / 989 TFLOP/s in bf16 or
               67 TFLOP/s in f32 without tensor cores); rwkv6_chunk at one
               layer's call, beside the same work as one-chunk launches, its
               host issue time, and one chunk alone
The last three lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.priority import BatchLimits  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.layers import layernorm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.planner import PlanExecutor, Planner  # noqa: E402
from repro_torch.serving import Frontend, build_real_engine  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
# tolerances of tests/test_kernels.py: f32 1e-5; bf16 2e-2 (paged), 3e-2
# (prefill); rwkv6_chunk 5e-4 (one chunk), 1e-3 (a chain against the oracle)
TOL = {("paged_attention", torch.float32): 1e-5,
       ("paged_attention", torch.bfloat16): 2e-2,
       ("flash_prefill", torch.float32): 1e-5,
       ("flash_prefill", torch.bfloat16): 3e-2,
       ("rwkv6_chunk", torch.float32): 5e-4}
RWKV_CHAIN_TOL = 1e-3
# A bf16 kernel computes in f32 and rounds once, so its output lies within half
# a bf16 ulp (<= 2^-8 |x|) of the plain version's f32 result, plus the f32
# tolerance twice over for the two summation orders. This catches a kernel that
# truncates or rounds a partial result to bf16, which the bf16 limits above
# (about 30% of a typical output) would let pass.
BF16_HALF_ULP = 2.0 ** -8
# full-model bf16 logits, kernels vs plain attention: relative to the largest
# |logit|. bf16 keeps 8 mantissa bits (3.9e-3 relative per rounding); the plain
# prefill rounds softmax weights to bf16 before PV while the kernel keeps them
# in f32, and those differences pass through 28 residual layers. For rwkv6-7b
# the kernel and the plain chunk sum in different orders in f32; a last-bit
# difference flips a bf16 rounding of the next layer's input, and that passes
# through 32 residual layers the same way (logits and the f32 state caches).
MODEL_REL_TOL = 5e-2
# rwkv6-7b at random init amplifies any last-bit difference layer by layer:
# in bf16, kernel vs plain chunks differ by 1.1e-2 of the largest logit after
# 4 layers and 0.22 after 32, and multiplying each plain chunk's output by
# (1 + 1e-6 randn) moves them by as much (2.1e-2 and 0.25; this script on an
# H100, 700 W). So the full-depth comparison is made in float32, where the
# same perturbation moves the logits by 1.2e-4 and kernel vs plain measured
# 1.0e-4: RWKV_F32_REL_TOL leaves a factor of ten. In bf16 the model is held
# to MODEL_REL_TOL at 4 layers and reported at 32.
RWKV_F32_REL_TOL = 1e-3
RWKV_BF16_LAYERS = 4
PERTURB = 1e-6
# At bf16 and full depth each layer is also held on its own, teacher-forced:
# every layer's time mix gets the plain run's input, so its kernel-vs-plain
# difference is not amplified by the layers before it. The f32 state is the
# kernel's direct output, chained over the prefill's chunks: RWKV_CHAIN_TOL of
# its largest value. The bf16 output differs where a last-bit difference of
# the f32 WKV output flips a bf16 rounding, as the PERTURB witness does on the
# same layer: it is held to WITNESS_FACTOR times the witness's difference, and
# never below one bf16 rounding (BF16_HALF_ULP) of its largest value.
WITNESS_FACTOR = 10.0

SOURCES = {"paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "flash_prefill": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "rwkv6_chunk": "src/repro_torch/kernels/csrc/rwkv6_chunk.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:78",
            "flash_prefill": "src/repro/kernels/flash_prefill.py:75",
            "rwkv6_chunk": "src/repro/kernels/rwkv6_chunk.py:61"}


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
    """The f32 tolerance enters twice, for the two summation orders."""
    lim = BF16_HALF_ULP * want32.abs() + 2 * TOL[(name, torch.float32)]
    worst = float(((out.float() - want32).abs() / lim).max())
    log(f"  {name} {label} bfloat16 vs f32 result: worst error {worst:.3f} of "
        f"half a bf16 ulp + {2 * TOL[(name, torch.float32)]:g}")
    check(worst <= 1.0, f"{name} {label}: bf16 output is not the f32 result "
          f"rounded once")


def upcast(args):
    return [a.float() if a.is_floating_point() else a for a in args]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 queued: bool = True) -> float:
    """Device time per call, CUDA events around ``iters`` calls. The calls
    are queued behind a device-side sleep, so they run back to back on the
    card whatever the host takes to issue them (a small kernel issues slower
    than it runs); the sleep grows until the host has queued every call
    before the device reaches the first event. ``queued=False`` for a call
    of hundreds of launches, more than the host can queue ahead: no sleep,
    so the time includes the host's gaps between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not queued:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters
    cycles = 50_000_000
    while True:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        queued_in_time = not t0.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return t0.elapsed_time(t1) / iters
        cycles *= 4


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


def rwkv_inputs(dtype, w_dtype=torch.float32, *, B=1, c=16, H=64, K=64, T=None,
                seed=3):
    """One WKV chunk at rwkv6-7b's widths (64 heads of 64), drawn as
    tests/test_kernels.py draws them: r/k/v and the state randn, logw =
    -exp(0.5 randn), u = 0.1 randn. With ``T`` the r/k/v/logw tensors span
    T tokens, as the model's [B, S, H, K] projections do."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = T or c

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (randn(B, T, H, K).to(dtype) for _ in range(3))
    logw = (-torch.exp(0.5 * randn(B, T, H, K))).to(w_dtype)
    return r, k, v, logw, 0.1 * randn(H, K), randn(B, H, K, K)


RWKV_CASES = [   # (label, input kwargs, out dtype): one chunk per launch
    ("path [1,16,64,64] bf16", {"dtype": torch.bfloat16}, torch.float32),
    ("c=32", {"dtype": torch.bfloat16, "c": 32}, torch.float32),
    ("c=64", {"dtype": torch.bfloat16, "c": 64}, torch.float32),
    ("all f32", {"dtype": torch.float32}, torch.float32),
]


def rwkv_layer_inputs(dtype, *, B=1, S=256, lens=None, cut=False, seed=5):
    """One layer's WKV call at rwkv6-7b's widths: r/k/v/logw [B, S, 64, 64]
    as rwkv_inputs draws them. ``lens``: row b's k and logw zeroed from token
    lens[b] on, as the model's ``valid`` mask does. ``cut``: each of r/k/v/
    logw is a view cut from a wider, longer projection (time offset 16,
    channels 16:80 of 96)."""
    r, k, v, logw, u, s0 = rwkv_inputs(dtype, B=B, c=S, T=S + 32 if cut else S,
                                       seed=seed)
    if cut:
        def wide(x):
            w = torch.zeros(x.shape[:3] + (96,), dtype=x.dtype, device=x.device)
            w[..., 16:80] = x
            return w[:, 16:16 + S, :, 16:80]
        r, k, v, logw = (wide(x) for x in (r, k, v, logw))
        check(not r.is_contiguous() and r.stride(1) == 64 * 96,
              "cut case is not strided")
    if lens is not None:
        for b, n in enumerate(lens):
            k[b, n:] = 0
            logw[b, n:] = 0
    return r, k, v, logw, u, s0


RWKV_LAYER_CASES = [   # (label, input kwargs, chunk, lens): one launch per layer
    ("layer [1,256,64,64] bf16", {"dtype": torch.bfloat16}, 16, None),
    ("max_len [1,1024] bf16", {"dtype": torch.bfloat16, "S": 1024}, 16, None),
    ("bucket [1,4096] bf16", {"dtype": torch.bfloat16, "S": 4096}, 32, None),
    ("[2,128] row 1 padded from 77", {"dtype": torch.bfloat16, "B": 2,
                                      "S": 128}, 16, [128, 77]),
    ("[4,512] views cut from wider projections",
     {"dtype": torch.bfloat16, "B": 4, "S": 512, "cut": True}, 16, None),
    ("all f32 [1,256]", {"dtype": torch.float32}, 16, None),
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


def sass_hmma_count(path) -> int | None:
    """Tensor-core instructions (HMMA) in a library's SASS, from the
    toolkit's cuobjdump; None where the toolkit has none."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return None
    return sum("HMMA" in line for line in res.stdout.splitlines())


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
    for b in built.values():
        n = sass_hmma_count(b.path)
        log(f"[build] {b.name}: HMMA in SASS: "
            f"{'not measured (no cuobjdump)' if n is None else n}")
        if b.name == "flash_prefill" and n is not None:
            check(n > 0, "flash_prefill's library has no tensor-core "
                         "instruction (HMMA)")


def phase_kernels() -> dict:
    """Kernel vs plain on the card. Returns the bf16 main-path errors."""
    errs = {}
    log("[kernels] paged_attention vs paged_attention_ref")
    # the serve's pool of 16-token pages at Qt 1 and 4; the planned serve's
    # pool of 8-token pages (8193 of them, contexts up to 512 tokens)
    cases = [(f"B=32 ctx<=1024 Qt={qt}", qt, {}) for qt in (1, 4)] + [
        ("page 8 B=32 ctx<=512 Qt=1", 1,
         {"page": PLANNED_BLOCK, "num_pages": 8193})]
    for dtype in (torch.bfloat16, torch.float32):
        for label, qt, geometry in cases:
            args = paged_inputs(dtype, num_q_tokens=qt, **geometry)
            out = ops.paged_attention(*args, num_q_tokens=qt)
            want = ref.paged_attention_ref(*args, num_q_tokens=qt)
            torch.cuda.synchronize()
            e = assert_close("paged_attention", out, want, dtype, label)
            if dtype == torch.bfloat16:
                want32 = ref.paged_attention_ref(*upcast(args), num_q_tokens=qt)
                assert_rounded_once("paged_attention", out, want32, label)
                if label == cases[0][0]:
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
    errs["rwkv6_chunk"] = rwkv_kernel_checks()
    return errs


def assert_chain_close(label: str, got, want) -> float:
    """Within RWKV_CHAIN_TOL (atol = rtol) of a chain of chunks' reference."""
    e = max_err(got, want)
    ok = bool(((got.float() - want.float()).abs()
               <= RWKV_CHAIN_TOL + RWKV_CHAIN_TOL * want.float().abs()).all())
    log(f"  rwkv6_chunk {label}: max_abs_err {e:.3e} (atol = rtol = "
        f"{RWKV_CHAIN_TOL:g})")
    check(ok, f"rwkv6_chunk {label}: kernel disagrees with its reference")
    return e


def chained_launches(r, k, v, logw, u, state, chunk, out_dtype):
    """The same work as n one-chunk launches, each carrying the state."""
    outs = []
    for i in range(r.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        o, state = ops.rwkv6_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u,
                                   state, out_dtype=out_dtype)
        outs.append(o)
    return torch.cat(outs, dim=1), state


def rwkv_kernel_checks() -> float:
    """rwkv6_chunk vs rwkv6_chunk_plain; returns the main-path max error (one
    layer's call of the serve, RWKV_LAYER_CASES[0])."""
    name, f32 = "rwkv6_chunk", torch.float32
    log("[kernels] rwkv6_chunk vs rwkv6_chunk_plain")
    for label, kw, out_dtype in RWKV_CASES:
        args = rwkv_inputs(**kw)
        o, s = ops.rwkv6_chunk(*args, out_dtype=out_dtype)
        want_o, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert_close(name, o, want_o, f32, f"o {label}")
        assert_close(name, s, want_s, f32, f"state {label}")
    # one launch per layer: n chunks against the chained plain version, and
    # against n chained one-chunk launches (the same arithmetic: expected 0)
    err = None
    for label, kw, chunk, lens in RWKV_LAYER_CASES:
        args = rwkv_layer_inputs(lens=lens, **kw)
        o, s = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=chunk)
        want_o, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=f32, chunk=chunk)
        e = assert_chain_close(f"o {label} c={chunk}", o, want_o)
        assert_chain_close(f"state {label} c={chunk}", s, want_s)
        chain_o, chain_s = chained_launches(*args, chunk, f32)
        torch.cuda.synchronize()
        log(f"  {name} {label}: one launch vs {args[0].shape[1] // chunk} "
            f"chained one-chunk launches: o {max_err(o, chain_o):.3e}, state "
            f"{max_err(s, chain_s):.3e} (expected 0)")
        if err is None:
            err = e
    # B=4 through strided chunk views of [4, 64, 64, 64] projections
    r, k, v, logw, u, s0 = rwkv_inputs(torch.bfloat16, B=4, T=64)
    views = [x[:, 16:32] for x in (r, k, v, logw)]
    check(not views[0].is_contiguous(), "strided case is not strided")
    o, s = ops.rwkv6_chunk(*views, u, s0, out_dtype=f32)
    want_o, want_s = ref.rwkv6_chunk_plain(*[x.contiguous() for x in views], u,
                                           s0, out_dtype=f32)
    assert_close(name, o, want_o, f32, "o B=4 strided views")
    assert_close(name, s, want_s, f32, "state B=4 strided views")
    # o in r's dtype, as the Pallas kernel writes it: the kernel's own f32
    # result rounded once to nearest, and within half a bf16 ulp of the plain
    # version's f32 result
    args = rwkv_inputs(torch.bfloat16)
    o16, _ = ops.rwkv6_chunk(*args)
    o32, _ = ops.rwkv6_chunk(*args, out_dtype=f32)
    check(o16.dtype == torch.bfloat16, f"default o dtype is {o16.dtype}")
    check(torch.equal(o16, o32.to(torch.bfloat16)),
          "rwkv6_chunk bf16 o is not its f32 result rounded to nearest")
    want32, _ = ref.rwkv6_chunk_plain(*args, out_dtype=f32)
    assert_rounded_once(name, o16, want32, "o path [1,16,64,64]")
    # 4 chunks against the token-by-token oracle: chained one-chunk launches,
    # then one launch
    r, k, v, logw, u, _ = rwkv_inputs(torch.float32, T=64, seed=4)
    s0 = torch.zeros((1, 64, 64, 64), device="cuda")
    want_o, want_s = ref.rwkv6_chunk_ref(r, k, v, logw, u, s0)
    chain = chained_launches(r, k, v, logw, u, s0, 16, f32)
    one = ops.rwkv6_chunk(r, k, v, logw, u, s0, chunk=16)
    torch.cuda.synchronize()
    for how, (got_o, got_s) in (("4-chunk chain", chain),
                                ("4 chunks in one launch", one)):
        assert_chain_close(f"{how} o vs rwkv6_chunk_ref", got_o, want_o)
        assert_chain_close(f"{how} state vs rwkv6_chunk_ref", got_s, want_s)
    return err


def full_model(arch: str, dtype: str = "", device="cuda"):
    """Full-width config (in ``dtype`` if given), model and random weights
    from SEED."""
    cfg = get_config(arch)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(SEED))
    return cfg, model, params


def phase_model_qwen(cfg, model, params, device="cuda") -> None:
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


def rwkv_outputs(m, params, toks, seq_lens):
    """Prefill logits, the prefill's state cache, and the logits of one decode
    step from that cache."""
    lg, cache = m.prefill(params, toks, seq_lens=seq_lens)
    state = cache["state"].clone()
    d, _ = m.decode_step(params, cache, lg.argmax(-1).to(torch.int32), seq_lens)
    return lg, state, d


def perturbed_plain(model):
    """The plain-chunk model with each chunk's output multiplied by
    (1 + PERTURB * randn): the model's own sensitivity to last-bit noise."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    m = model.with_wkv_impl("plain")

    def wkv(r, k, v, logw, u, state, *, chunk):
        outs = []
        for i in range(r.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            o, state = ref.rwkv6_chunk_plain(r[:, sl], k[:, sl], v[:, sl],
                                             logw[:, sl], u, state,
                                             out_dtype=torch.float32)
            noise = torch.randn(o.shape, generator=g, device=o.device)
            outs.append(o * (1 + PERTURB * noise))
        return torch.cat(outs, dim=1), state

    m._wkv = wkv
    return m


def phase_model_rwkv(cfg, model, params, tol, device="cuda") -> None:
    """One prefill at B=2, L=128 (one row padded) and one decode step from
    each cache, kernel vs plain WKV chunks, beside what a PERTURB relative
    perturbation of each plain chunk's output does to the same numbers.
    ``tol`` None: report only."""
    B, L = 2, 128
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, L)),
                           dtype=torch.int32, device=device)
    seq_lens = torch.as_tensor([128, 77], dtype=torch.int32, device=device)
    kern = rwkv_outputs(model.with_wkv_impl("kernel"), params, toks, seq_lens)
    plain = rwkv_outputs(model.with_wkv_impl("plain"), params, toks, seq_lens)
    pert = rwkv_outputs(perturbed_plain(model), params, toks, seq_lens)
    what = (f"{cfg.num_layers} layers {cfg.dtype} B={B} L={L} seq_lens "
            f"[128, 77]")
    for i, label in enumerate(("prefill logits", "prefill state",
                               "decode logits")):
        got, want = kern[i], plain[i]
        scale = float(want.float().abs().max())
        rel = max_err(got, want) / scale
        floor = max_err(pert[i], want) / scale
        same = ""
        if "logits" in label:
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            same = f"; argmax agreement {agree:.2f}"
        log(f"[rwkv model] {what} {label}: kernel vs plain max_abs_err "
            f"{max_err(got, want):.3e} (max |value| {scale:.3e}, rel {rel:.3e}, "
            f"tol {tol if tol is not None else 'reported only'}); plain with "
            f"its chunk outputs perturbed by {PERTURB:g}: rel {floor:.3e}{same}")
        check(bool(torch.isfinite(got.float()).all()), f"non-finite {label}")
        if tol is not None:
            check(rel <= tol, f"{what} {label}: kernel vs plain disagree")
    check(tuple(kern[1].shape) == (cfg.num_layers, B, model.n_heads,
                                   cfg.rwkv_head_dim, cfg.rwkv_head_dim)
          and kern[1].dtype == torch.float32, "state cache layout")


def phase_layers_rwkv(cfg, model, params, device="cuda") -> None:
    """Every layer's time mix at the path's dtype and depth, teacher-forced:
    the kernel, the plain chunks and the PERTURB witness all get the plain
    run's input to that layer, at B=2 L=128 with one row padded."""
    B, Ln = 2, 128
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, Ln)),
                           dtype=torch.int32, device=device)
    seq_lens = torch.as_tensor([128, 77], dtype=torch.int32, device=device)
    valid = (torch.arange(Ln, device=device)[None, :] < seq_lens[:, None]).float()
    kern, plain = model.with_wkv_impl("kernel"), model.with_wkv_impl("plain")
    pert = perturbed_plain(model)
    worst = {"out": (-1.0, 0.0, 0), "state": (-1.0, 0)}
    with torch.no_grad():
        x = layernorm(plain.embed_tokens(params, toks), params["ln0_s"],
                      params["ln0_b"], cfg.norm_eps)
        for g in range(cfg.num_layers):
            pp = {k: v[g] for k, v in params["blocks"].items()}
            h = layernorm(x, pp["ln1_s"], pp["ln1_b"], cfg.norm_eps)
            zero = torch.zeros_like(h[:, 0])
            o_p, s_p, _ = plain._time_mix_seq(pp, h, zero, valid)
            o_k, s_k, _ = kern._time_mix_seq(pp, h, zero, valid)
            o_w, _, _ = pert._time_mix_seq(pp, h, zero, valid)
            scale = float(o_p.float().abs().max())
            rel, wit = max_err(o_k, o_p) / scale, max_err(o_w, o_p) / scale
            limit = max(WITNESS_FACTOR * wit, BF16_HALF_ULP)
            s_rel = max_err(s_k, s_p) / float(s_p.abs().max())
            log(f"[rwkv layers] layer {g:2d}: output rel {rel:.3e} (witness "
                f"{wit:.3e}, limit {limit:.3e}); state rel {s_rel:.3e} "
                f"(limit {RWKV_CHAIN_TOL:g})")
            check(bool(torch.isfinite(o_k.float()).all())
                  and bool(torch.isfinite(s_k).all()),
                  f"layer {g}: non-finite time-mix output or state")
            check(rel <= limit, f"layer {g}: time-mix output, kernel vs plain "
                                f"disagree")
            check(s_rel <= RWKV_CHAIN_TOL, f"layer {g}: WKV state, kernel vs "
                                           f"plain disagree")
            if rel > worst["out"][0]:
                worst["out"] = (rel, wit, g)
            if s_rel > worst["state"][0]:
                worst["state"] = (s_rel, g)
            x, _ = plain._block_seq(x, pp, False, seq_lens)
    log(f"[rwkv layers] {cfg.num_layers} layers {cfg.dtype}, teacher-forced: "
        f"worst output rel {worst['out'][0]:.3e} (layer {worst['out'][2]}, "
        f"witness {worst['out'][1]:.3e}); worst state rel "
        f"{worst['state'][0]:.3e} (layer {worst['state'][1]})")


def serve_trace(vocab_size: int = 151934, **kw):
    """The serve phases' rotten trace; ``kw`` overrides TraceConfig fields."""
    tok = HashTokenizer(vocab_size=vocab_size)
    ds = make_dataset("rotten", num_rows=1000, seed=SEED)
    cfg = dict(num_relqueries=8, rate=4.0, seed=SEED, max_requests=8,
               output_token_cap=16)
    return build_trace(ds, TraceConfig(**dict(cfg, **kw)), tokenizer=tok)


# (kv backend, max_slots) of each path's serve; rwkv6-7b runs with as many
# slots as layers on purpose (a slot axis found by its size would be wrong)
SERVE = {"qwen3-1.7b": ("paged", 64), "rwkv6-7b": ("dense", 32)}


def run_serve(model, params, trace, loop: str, device="cuda", card: str = ""):
    """Serve ``trace``; returns (token streams, number of prefill calls). The
    calls are counted on the dense backend, whose executor calls the model it
    is given (the paged one builds a sibling): None on the paged backend."""
    arch = model.cfg.name
    backend, max_slots = SERVE[arch]
    trace = copy.deepcopy(trace)
    prefills = [0] if backend == "dense" else [None]
    counted = copy.copy(model)

    def prefill(*args, **kw):
        prefills[0] += 1
        return model.prefill(*args, **kw)

    if backend == "dense":
        counted.prefill = prefill
    engine = build_real_engine(arch, "relserve", backend, model=counted,
                               params=params, max_slots=max_slots, max_len=1024,
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
    if backend == "paged":
        ex.bm.check_invariants()
        check(ex.bm.free_blocks == ex.bm.num_blocks
              and ex.kv_tokens_resident() == 0,
              f"{loop}: the paged pool did not drain")
        where = f"pool {ex.num_blocks + 1} blocks"
    else:
        check(all(s is None for s in ex.slots) and not ex._slot_of,
              f"{loop}: a dense slot was not freed")
        where = f"{max_slots} dense slots"
    fitted = ex.fitted_model()
    log(f"[serve] {arch} {backend} {loop}: {len(report.latencies)} relQueries, "
        f"{sum(len(rq.requests) for rq in trace)} requests, {n_tok} tokens; "
        f"latency avg {report.avg_latency:.4f}s p50 {report.percentile(50):.4f}s "
        f"p99 {report.percentile(99):.4f}s; wall {wall:.3f}s, "
        f"{n_tok / wall:.1f} tokens/s; {len(report.events)} batches; "
        f"{where}; fitted alpha_p {fitted.alpha_p:.3e} "
        f"beta_p {fitted.beta_p:.3e} alpha_d {fitted.alpha_d:.3e} "
        f"beta_d {fitted.beta_d:.3e}; "
        f"{'' if prefills[0] is None else f'{prefills[0]} prefill calls; '}{card}")
    streams = [tuple(r.output_tokens) for rq in trace for r in rq.requests]
    del engine, ex
    if device == "cuda":
        torch.cuda.empty_cache()
    return streams, prefills[0]


def phase_serve(model, params, *, exact: bool = False) -> dict:
    """Serial then pipelined serve; each must launch the kernels of this
    model's own path. ``exact``: the two runs' streams must be identical.
    Returns this path's launch counts."""
    card = nvidia_smi_line()
    trace = serve_trace(model.cfg.vocab_size - 2)
    ops.reset_launch_counts()
    serial, n_serial = run_serve(model, params, trace, "serial", card=card)
    after_serial = ops.launch_counts()
    pipelined, n_pipe = run_serve(model, params, trace, "pipelined", card=card)
    counts = ops.launch_counts()
    log(f"[serve] {model.cfg.name} launches: serial {after_serial}, "
        f"serial + pipelined {counts}")
    for name in model.KERNELS:
        check(after_serial[name] > 0, f"serial serve never launched {name}")
        check(counts[name] > after_serial[name],
              f"pipelined serve never launched {name}")
    if "rwkv6_chunk" in model.KERNELS:   # one launch per layer per prefill
        L = model.cfg.num_layers
        log(f"[serve] {model.cfg.name} rwkv6_chunk launches per prefill call: "
            f"serial {after_serial['rwkv6_chunk'] / n_serial:g}, pipelined "
            f"{(counts['rwkv6_chunk'] - after_serial['rwkv6_chunk']) / n_pipe:g} "
            f"({n_serial} and {n_pipe} prefill calls; {L} layers)")
        check(after_serial["rwkv6_chunk"] == L * n_serial
              and counts["rwkv6_chunk"] == L * (n_serial + n_pipe),
              "rwkv6_chunk is not one launch per layer per prefill")
    same = sum(a == b for a, b in zip(serial, pipelined)) / len(serial)
    log(f"[serve] {model.cfg.name} identical streams serial vs pipelined: "
        f"{same:.3f} ({card})")
    if exact:
        check(serial == pipelined, "serial and pipelined streams differ")
    return {name: counts[name] for name in model.KERNELS}


# The planned serve (phase 7): the serve trace with half of each relQuery's
# rows exact copies of earlier rows, 16 relQueries with outputs up to 32
# tokens, all arriving at once. With every relQuery present from the start
# the scheduler's decisions follow from the trace alone, not from the measured
# batch times (staggered arrivals let a fast host finish one relQuery before
# the next arrives, and the cap is then never reached).
PLANNED_TRACE = dict(num_relqueries=16, output_token_cap=32, rate=1e9,
                     dup_row_fraction=0.5)
# The templates' common prefixes are 13 tokens, under one block of 16; blocks
# of 8 share them physically.
PLANNED_BLOCK = 8
# The device KV cap C, in multiples of the trace's largest request footprint
# (prompt + output cap): tight enough that decode growth overflows it and the
# scheduler reclaims (tests/test_torch_engine.py derives its cap the same way).
PLANNED_CAP_FACTOR = 3.0
# The swap cost model's link rate: at the default 32 GB/s a swap is always
# cheaper than re-prefill, so no victim is ever recomputed. At 8 GB/s victims
# under ~240 tokens swap to the host tier and longer ones are preempted and
# recomputed, so both reclaim paths run in one serve.
PLANNED_SWAP_GBPS = 8.0


def watch_cow(ex, bad: list) -> None:
    """Record every copy-on-write append whose sequence's block table does
    not point at the fresh copy right after it (so the next decode would
    read the shared page)."""
    bm = ex.bm
    inner = bm.append_token_cow

    def append_token_cow(seq_id):
        bid, cow = inner(seq_id)
        if cow is not None:
            src, dst = cow
            table = bm.block_table(seq_id)
            if dst not in table or src in table:
                bad.append((seq_id, cow, list(table)))
        return bid, cow

    bm.append_token_cow = append_token_cow


def planned_cap(trace) -> int:
    return int(PLANNED_CAP_FACTOR * max(r.num_prompt_tokens + r.max_output_tokens
                                        for rq in trace for r in rq.requests))


def planned_engine(model, params, loop: str, cap: int, device="cuda"):
    return build_real_engine(
        model.cfg.name, "relserve", "paged", model=model, params=params,
        max_slots=64, max_len=1024, block_size=PLANNED_BLOCK, engine_loop=loop,
        prefix_sharing=True, kv_admission="optimistic", kv_tiering=True,
        proactive_offload=True, swap_prefetch=True,
        limits=BatchLimits(cap=cap), host_kv_cap=4 * cap,
        swap_bandwidth_gbps=PLANNED_SWAP_GBPS, device=device)


def run_planned(model, params, trace, loop: str, cap: int, device="cuda",
                card: str = "") -> list:
    """Replay ``trace`` through the planner (dedup + prefix-maximizing
    reorder) on the tight-cap, prefix-shared, KV-tiered paged engine and
    check it. Returns every logical row's stream, in trace order."""
    trace = copy.deepcopy(trace)
    engine = planned_engine(model, params, loop, cap, device)
    ex = engine.executor
    bad_cow: list = []
    watch_cow(ex, bad_cow)
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size - 2)
    planner = Planner("full", tokenizer=tok)
    planned = planner.plan_trace(trace)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    report = PlanExecutor(Frontend(engine), planner).replay(planned)
    sync()
    wall = time.perf_counter() - t0
    rows = [r for p in planned for r in p.logical_requests]
    n_tok = sum(len(r.output_tokens) for p in planned
                for r in p.physical.requests)
    check(sorted(report.latencies) == sorted(rq.rel_id for rq in trace),
          f"planned {loop}: not every relQuery finished")
    for r in rows:
        check(1 <= len(r.output_tokens) <= r.max_output_tokens,
              f"planned {loop}: row {r.req_id} has {len(r.output_tokens)} tokens")
    for p in planned:
        leaders = {r.req_id: r for r in p.physical.requests}
        for leader_id, followers in p.fanout.items():
            for f in followers:
                check(f.output_tokens == leaders[leader_id].output_tokens,
                      f"planned {loop}: deduped row {f.req_id} differs from "
                      f"its representative {leader_id}")
    deduped = sum(p.deduped_requests for p in planned)
    check(report.deduped_requests == deduped > 0,
          f"planned {loop}: {report.deduped_requests} rows answered by dedup")
    for name, n in (("shared KV tokens", report.shared_kv_tokens),
                    ("shared prefix block hits", ex.shared_block_hits),
                    ("preemptions", report.preemptions),
                    ("swap-outs", report.swap_outs),
                    ("swap-ins", report.swap_ins)):
        check(n > 0, f"planned {loop}: no {name} (cap {cap} tokens)")
    check(not bad_cow, f"planned {loop}: a block table still points at the "
          f"shared page after copy-on-write: {bad_cow[:3]}")
    ex.bm.check_invariants()
    check(ex.bm.free_blocks == ex.bm.num_blocks
          and ex.kv_tokens_resident() == 0,
          f"planned {loop}: the device pool did not drain")
    check(ex.bm.host_free_blocks == ex.bm.num_host_blocks
          and ex.bm.host_tokens_in_use() == 0 and not ex._host_stash,
          f"planned {loop}: the host pool did not drain")
    log(f"[planned] {model.cfg.name} paged {loop}: {len(trace)} relQueries, "
        f"{len(rows)} logical rows -> {len(rows) - deduped} physical "
        f"({deduped} deduped), {n_tok} tokens decoded; latency avg "
        f"{report.avg_latency:.4f}s p50 {report.percentile(50):.4f}s p99 "
        f"{report.percentile(99):.4f}s; wall {wall:.3f}s, "
        f"{n_tok / wall:.1f} tokens/s; {len(report.events)} batches; cap "
        f"{cap} tokens, pool {ex.num_blocks + 1} blocks of {ex.block_size}, "
        f"host {ex.num_host_blocks} blocks; shared: {report.shared_kv_tokens} "
        f"KV tokens, {ex.shared_block_hits} prefix block hits, "
        f"{ex.cow_copies} cow copies; {report.preemptions} preemptions "
        f"({report.preempted_tokens} tokens); {report.swap_outs} swap-outs "
        f"({report.swapped_out_tokens} tokens), {report.swap_ins} swap-ins "
        f"({report.swapped_in_tokens} tokens), {report.proactive_offloads} "
        f"proactive offloads, {report.swap_prefetches} prefetches; {card}")
    streams = [tuple(r.output_tokens) for r in rows]
    del engine, ex
    if device == "cuda":
        torch.cuda.empty_cache()
    return streams


def phase_planned(model, params, device="cuda") -> dict:
    """The planned, prefix-shared, KV-tiered serve, serial then pipelined;
    each loop must launch both attention kernels. Then the same engine
    serves the trace unplanned, and the share of rows whose streams match is
    reported (not checked: in bf16 another batch composition may change a
    greedy token). Returns the two loops' launch counts."""
    card = nvidia_smi_line() if device == "cuda" else "cpu"
    trace = serve_trace(model.cfg.vocab_size - 2, **PLANNED_TRACE)
    cap = planned_cap(trace)
    ops.reset_launch_counts()
    serial = run_planned(model, params, trace, "serial", cap, device, card)
    after_serial = ops.launch_counts()
    pipelined = run_planned(model, params, trace, "pipelined", cap, device, card)
    counts = ops.launch_counts()
    log(f"[planned] launches: serial {after_serial}, serial + pipelined {counts}")
    for name in model.KERNELS:
        check(after_serial[name] > 0, f"planned serial serve never launched {name}")
        check(counts[name] > after_serial[name],
              f"planned pipelined serve never launched {name}")
    tr = copy.deepcopy(trace)
    planned_engine(model, params, "serial", cap, device).run_trace(tr)
    unplanned = [tuple(r.output_tokens) for rq in tr for r in rq.requests]
    n = len(serial)
    log(f"[planned] identical streams: planned serial vs pipelined "
        f"{sum(a == b for a, b in zip(serial, pipelined)) / n:.3f}, planned "
        f"vs unplanned {sum(a == b for a, b in zip(serial, unplanned)) / n:.3f} "
        f"({n} rows; {card})")
    return {name: counts[name] for name in model.KERNELS}


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

    # rwkv6_chunk at one layer's call of the serve: r/k/v bf16 [1, 256, 64,
    # 64] in chunks of 16, logw / u / state f32, o f32
    f32 = torch.float32
    args = rwkv_layer_inputs(torch.bfloat16)
    r, k, v, logw, u, s0 = args
    B, S, H, K = r.shape
    V = v.shape[3]
    c = 16
    outs = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=c)
    nbytes = (sum(x.numel() * x.element_size() for x in args)
              + sum(x.numel() * x.element_size() for x in outs))
    pairs = c * (c - 1) // 2
    flops = B * H * (S // c) * (4 * c * K * V         # rd @ S and ks^T v
                                + c * (c + 1) * V     # A @ v, lower triangle
                                + 4 * pairs * K       # decayed products of A
                                + 3 * c * K + K * V)  # diagonal, decay of S
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    ms = cuda_time_ms(lambda: ops.rwkv6_chunk(*args, out_dtype=f32, chunk=c))
    chained = cuda_time_ms(lambda: chained_launches(*args, c, f32))
    # ~30 launches per chunk: too many to queue ahead of the device
    plain = cuda_time_ms(lambda: ref.rwkv6_chunk_plain(*args, out_dtype=f32,
                                                       chunk=c),
                         iters=5, warmup=1, queued=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ops.rwkv6_chunk(*args, out_dtype=f32, chunk=c)
    issue = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    one = rwkv_inputs(torch.bfloat16)    # one chunk [1, 16, 64, 64] alone
    one_ms = cuda_time_ms(lambda: ops.rwkv6_chunk(*one, out_dtype=f32))
    log(f"[times] rwkv6_chunk r={list(r.shape)} bf16 c={c}, o f32 (one layer's "
        f"call): kernel {ms:.4f} ms, the same work as {S // c} one-chunk "
        f"launches {chained:.4f} ms, plain {plain:.4f} ms (not queued: with "
        f"the host's gaps), bound {bound:.4f} ms "
        f"(flops {flops}, bytes {nbytes}), library null; host issue "
        f"{issue:.4f} ms per call; one chunk r=[1, 16, 64, 64]: {one_ms:.4f} ms")
    out.append({"name": "rwkv6_chunk", "route": "cuda",
                "source": SOURCES["rwkv6_chunk"],
                "replaces": REPLACES["rwkv6_chunk"],
                "launches": counts["rwkv6_chunk"],
                "max_abs_err": errs["rwkv6_chunk"], "ms": ms,
                "plain_ms": plain, "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None})
    return out


def phase_profile(model, params, device="cuda", planned: bool = False) -> None:
    """Where a serve phase's time goes: one more serial serve of the same
    trace under torch.profiler (after the launch counters were read), the
    planned serve of phase 7 with ``planned``. Prints the device's busy and
    idle share of the wall time and the kernels that take the device time.
    The planned serve launches ~700k kernels: it is traced on the device
    only, since the host's operator events would multiply the trace and the
    time to sum it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [] if planned and device == "cuda" else [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if planned:
        trace = serve_trace(model.cfg.vocab_size - 2, **PLANNED_TRACE)
        cap = planned_cap(trace)
    else:
        trace = serve_trace(model.cfg.vocab_size - 2)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if planned:
            run_planned(model, params, trace, "serial", cap, device)
            n_prefill = None
        else:
            _, n_prefill = run_serve(model, params, trace, "serial", device)
        wall_us = (time.perf_counter() - t0) * 1e6
    t1 = time.perf_counter()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    log(f"[profile] summing the trace took {time.perf_counter() - t1:.1f}s")
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("[profile] the profiler recorded no device time: not measured")
        return
    launches = sum(e.count for e in kernels)
    log(f"[profile] {model.cfg.name} {'planned ' if planned else ''}serial "
        f"serve under the profiler: wall "
        f"{wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of wall, "
        f"idle {1 - busy_us / wall_us:.3f}), {launches} kernel launches"
        f"{'' if n_prefill is None else f', {n_prefill} prefill calls'}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f}  x{e.count:<6d} "
            f"{e.key[:90]}")
    for e in kernels:   # this repo's kernels, wherever they rank
        if "relserve::" in e.key:
            name = e.key.split("(anonymous namespace)::")[1].split("(")[0]
            log(f"[profile] own kernel {name}: {e.self_device_time_total / 1e3:.2f} "
                f"ms over {e.count} launches, "
                f"{e.self_device_time_total / max(e.count, 1):.2f} us each")


def load_model(arch: str, dtype: str = ""):
    cfg, model, params = full_model(arch, dtype)
    log(f"[model] {cfg.name}: {model.param_count() / 1e9:.3f}B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}")
    return cfg, model, params


def lap(label: str, t0: float) -> float:
    """Log the seconds since ``t0`` under ``label``; returns now."""
    now = time.perf_counter()
    log(f"[time] {label}: {now - t0:.1f}s")
    return now


def main() -> None:
    t_start = t = time.perf_counter()
    phase_device()
    phase_build()
    t = lap("device and build", t)
    errs = phase_kernels()
    t = lap("kernels", t)

    cfg, model, params = load_model("qwen3-1.7b")
    phase_model_qwen(cfg, model, params)
    t = lap("qwen3 model", t)
    counts = phase_serve(model, params)
    t = lap("qwen3 serve", t)
    phase_profile(model, params)
    t = lap("qwen3 profile", t)
    planned = phase_planned(model, params)
    counts = {name: counts[name] + planned[name] for name in counts}
    t = lap("qwen3 planned serve", t)
    phase_profile(model, params, planned=True)
    t = lap("qwen3 planned profile", t)
    del cfg, model, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model, params = load_model("rwkv6-7b", dtype="float32")
    phase_model_rwkv(cfg, model, params, RWKV_F32_REL_TOL)
    t = lap("rwkv6 model f32", t)
    del cfg, model, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model, params = load_model("rwkv6-7b")
    n = RWKV_BF16_LAYERS
    phase_model_rwkv(cfg.replace(num_layers=n), model.with_layers(n),
                     dict(params, blocks={k: v[:n] for k, v
                                          in params["blocks"].items()}),
                     MODEL_REL_TOL)
    phase_layers_rwkv(cfg, model, params)
    phase_model_rwkv(cfg, model, params, None)
    t = lap("rwkv6 model bf16", t)
    counts.update(phase_serve(model, params, exact=True))
    t = lap("rwkv6 serve", t)
    phase_profile(model, params)
    t = lap("rwkv6 profile", t)
    del cfg, model, params
    gc.collect()
    torch.cuda.empty_cache()

    kernels = phase_times(errs, counts)
    lap("times", t)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
