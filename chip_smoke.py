"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; none catches its own):
  1. device  — CUDA with compute capability >= 9.0; card name and power limit
  2. build   — nvcc builds the three kernels from src/repro_torch/kernels/csrc/
               for sm_90a, one process each, in parallel; prints ptxas'
               registers / shared memory / spills, each library's lines of
               wgmma (HGMMA), TMA loads (UTMALDG) and mma.sync (HMMA) in its
               SASS from cuobjdump ("not measured" without it; every
               library must show UTMALDG, flash_prefill HGMMA, rwkv6_chunk
               HMMA), and
               each kernel instance's registers, shared memory and resident
               blocks per SM from the library's own occupancy query
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               at main-path shapes (paged_attention also at the planned
               serve's 8-token pages), bf16 and f32, TF32 off; each bf16 output
               also within half a bf16 ulp of the plain version's f32 result.
               Which kernel serves which dtype: flash_prefill bf16 runs on
               wgmma on a TMA-fed ring at hd 64 and 128 (P split into bf16
               hi + lo), on the SIMT kernel at 16 and 32, f32 on the SIMT
               kernel; paged_attention is one split-KV launch for both
               (K/V by TMA, the splits merged by the last block of each
               sequence and kv slot); rwkv6_chunk takes bf16 or
               f32 r/k/v with f32 state; it is one call of two launches,
               a chunk-parallel pass and the state carry. rwkv6_chunk one
               chunk per call at c = 16 / 32 / 64 and through strided chunk
               views; one call per layer (every chunk of [1, 256],
               [1, 1024], [1, 4096] at c = 32, [1, 12288] at c = 64, a
               padded row, views cut from wider projections, f32) against
               the chained plain version and, bit for bit, against chained
               one-chunk calls; 4 chunks, chained and in one call, against
               the sequential oracle. Both attention
               kernels also at the other paged models' shapes (granite-moe:
               3 q rows per kv slot, head_dim 64; qwen3-moe: 8 rows,
               qwen2.5-32b: 5, internvl2-26b: 6, head_dim 128), and rwkv6-7b's WKV call through the model at S 1000 and
               12288, whose reference chunk lengths (8, 96) the kernel does
               not take (the model pads to, or picks, one it takes)
  The paths follow, each serve driven with the launch counters set to 0 just
  before and read just after; each must launch the kernels of its own model,
  one launch per layer per prefill call or decode step. Every serve runs its
  executor's steps as CUDA graphs, one per shape bucket (engine/graphs.py):
  a replay adds its capture's launches to the counters, and the executor
  counts the prefill calls and decode steps. The graphs phases ("graphs"
  below) hold them against the executors' eager steps (eager=True):
  4. qwen3   — full-width qwen3-1.7b (28 layers, bf16, random weights from a
     model     seed): one prefill batch and one paged decode step, kernels vs
               the plain attention path
  5. qwen3   — the paged engine with the paper's scheduler serving a rotten
     serve     trace, serial then pipelined loop (paged_attention, flash_prefill)
  6. qwen3   — graphs against eager steps (phase_graphs) on the serve trace
     graphs    with every relQuery at t = 0 (both serve the same batches):
               one prefill and one decode step captured beside the same
               step called eagerly (logits bit for bit, else the largest
               difference); a graphed and an eager serve, serial and
               pipelined: identical streams, equal launches per kernel,
               both walls, the graphs, capture and prestage seconds, graph
               pool bytes and peak memory; then a window of a serial serve
               of each traced on the device only, its executor having
               captured the graphed serve's buckets first (the steady
               state; the serve stops after the window): the device's busy
               share of the window's wall time, host launches (a graph's
               replay is one) and device kernels per batch, and the
               kernels that take the time
  7. qwen3   — the workload planner (dedup fan-out, prefix-maximizing
     planned   reorder) in front of the paged engine with physically shared
               prefix blocks, optimistic admission at a tight KV cap,
               preemption, swaps to a host tier with proactive offload and
               prefetch; serial then pipelined. Checks every row's stream,
               the dedup fan-out, shared blocks, preemptions, swaps, both
               pools drained; reports the share of rows whose streams equal
               an unplanned serve of the same engine; then one more planned
               serial serve (graphed), a window of its batches profiled as
               in phase 6
  8. rwkv6   — full-width rwkv6-7b (random weights from the seed), in float32
     model     at full depth (32 layers) and in bf16 at 4 layers (reported at
               32): one prefill at B=2 L=128 and one decode step from each
               cache, kernel vs plain WKV chunks, beside the plain chunks with
               their outputs perturbed by 1e-6 (the model's own sensitivity);
               and in bf16 at 32 layers each layer's time mix on its own,
               teacher-forced (output and state, kernel vs plain)
  9. rwkv6   — the dense engine serving the same trace, serial then pipelined
     serve     (rwkv6_chunk, one call per layer per prefill call); the two
               runs' streams must be identical; the (B, S, chunk) of every
               rwkv6_chunk call is counted from the executors' buckets
               (timed in phase 24)
 10. rwkv6   — phase 6's graphs against eager (serial), and rwkv6_chunk
     graphs    replayed from a CUDA graph against the eager call, bit for
               bit
 11. granite — full-width, full-depth granite-moe-3b-a800m (40 experts, top 8):
     model     one prefill batch and one paged decode step, kernels vs plain
               attention: in float32 (full rows, beside the PERTURB witness)
               and in bf16 at 4 layers (full rows); in bf16 at 4 and 32
               layers (ragged rows) against the float32 model on the same
               weights, routes replayed, beside the plain path as control,
               and kernels vs plain with the plain path's routes replayed
 12. granite — the paged engine serving the rotten trace, serial then
     serve     pipelined; the share of rows whose streams agree is reported
 13. granite — phase 6's graphs against eager (serial)
     graphs
 14. qwen3   — qwen3-moe-30b-a3b at full width cut to 4 layers (128 experts):
     moe       prefill and paged decode, kernels vs plain in float32; in
               bf16 against the float32 model and with routes replayed, as
               granite-moe; then at all 48 layers in bf16, its weights drawn
               one layer at a time (init_params' by_layer; each init logs
               its peak memory): kernels vs plain with the plain path's
               routes replayed, and the paged serve in both loops (the
               share of rows whose streams agree reported), 16 slots
 14a. qwen2.5 — qwen2.5-32b (64 layers, d_model 5120, 40 q / 8 kv heads of
      32b       128: 5 q rows per kv slot, QKV bias), drawn by layer: kernels
               vs plain in float32 at 4 layers (full rows, beside the
               PERTURB witness) and in bf16 at 64; the paged serve in both
               loops, 16 slots (the serve gate of phase 5; peak memory
               logged); phase 6's graphs against eager (serial)
 14b. intern- — the internvl2-26b backbone (48 layers, d_model 6144, 48 / 8
      vl2       heads of 128: 6 rows per slot), as phase 14a without the
               graphs against eager
 15. gemma3  — gemma3-12b (5 window layers : 1 global, window 1024): a prefill
               past the window and 4 decode steps against one pass over the
               extended sequence, in float32 at one 6-layer group and bf16
               at 48 layers (reported); then a short serial serve on the
               dense engine, which launches no kernel of this repo (its
               attention is plain, as in the reference)
 16. hymba   — hymba-1.5b at full width (32 layers, d_model 1600, 25 q / 5 kv
     model     heads of 64, Mamba d_inner 3200, ssm_state 16, window 1024):
               gemma3's window check (prefill [1148, 1090] + 4 decode steps
               vs one pass) in float32 at 4 layers (held, 1e-5) and in bf16
               at 4 layers (held, MODEL_REL_TOL) and 32 (reported)
 17. hymba   — the dense engine serving the rotten trace, serial then
     serve     pipelined; streams identical; no kernel of this repo launches
 18. hymba   — phase 6's graphs against eager (serial)
     graphs
 19. whisper — whisper-base at full width and depth (6 + 6 layers, d_model
               512, 1500 encoder frames, max_target_len 448): ragged frame
               lengths, a prefill of 64 tokens and 4 decode steps vs one
               decoder pass, float32 held (1e-5), bf16 reported
 20. train   — qwen3-1.7b at full width and depth through the captured train
               step (TrainStep: the first call a real step run eagerly,
               then one CUDA graph of the whole step replayed; bf16
               params, float32 masters, batch 8 x 128, lr 1e-3, remat):
               25 steps on one batch, the last loss below 0.8 x the first;
               two replays traced on the device; then the eager in-place
               step on the same trees, two of its steps traced: step time,
               host launches per step, idle share, capture seconds, graph
               pool and peak memory side by side; 3 replays of a step
               captured under deterministic algorithms against 3 eager
               steps from the same state, bit for bit; a checkpoint
               written, read back bit for bit, and a replay after
               load_state of it bit-identical to one from the live state
 21. train   — one train step of each family (qwen3 and qwen2 dense,
     families  granite and qwen3-moe, rwkv6, hymba, whisper) at full width
               cut to 2 layers, under deterministic algorithms: the eager
               step with synchronising CUDA calls made errors, then one
               replay of the captured step from the same state: loss, grad
               norm and new parameters bit for bit
               Phases 19-21 launch no kernel of this repo (checked); phases 22
               and 23 launch flash_prefill once per layer per qwen3 prefill,
               phase 23 also rwkv6_chunk once per layer per rwkv6 prefill.
 22. multi-  — a one-rank NCCL process group (a file store under a temporary
     device    directory) and a (1, 1) ("data", "model") DeviceMesh: qwen3-1.7b
               at full width, prefilled by DenseTransformer(cfg, pc) with
               flash_prefill, its cache resharded, then 4 sequence-parallel
               decode steps (params and cache DTensors, every collective
               through NCCL) against decode_step from the same cache, float32
               at 4 layers (1e-5) and bf16 at 28 (MODEL_REL_TOL), the two
               steps timed and the collectives of one counted;
               granite-moe-3b-a800m with local expert parallelism against
               moe_dispatch (float32 at 4 layers, bf16 at 32 with routes
               replayed); a ZeRO-1 AdamW step against the plain one and
               reshard_tree / elastic_restore of a checkpoint (qwen3-1.7b at
               2 layers). One rank checks no cross-rank arithmetic: that is
               tests/test_torch_layers.py's 8-rank gloo world on the CPU
 23. tp      — the whole-model tensor-parallel forward on a one-rank NCCL
     forward,  (1, 1) mesh (DTensor weights placed by param_specs) against the
     cells,    single-device path: prefill and decode logits, train loss and
     dry run   gradients of qwen3-1.7b (float32 at 4 layers, 1e-6 / 1e-5;
               bf16 at 28, MODEL_REL_TOL) and granite-moe-3b-a800m (float32
               at 4 layers, routes replayed); of rwkv6-7b (its prefill
               through rwkv6_chunk on the rank's WKV heads) and hymba-1.5b
               (float32 at 4 layers, bf16 at 32) and whisper-base (float32
               and bf16 at 6 + 6, 1500 frames); one train step with
               train_layout "fsdp" and one with compress_grads of qwen3-1.7b
               (4 layers) and rwkv6-7b (2) against the same cells' steps on
               one device (new parameters, m, v, err); the production
               meshes' dry run (launch/dryrun.py) of qwen3-1.7b,
               granite-moe-3b-a800m, rwkv6-7b, hymba-1.5b and whisper-base,
               two subprocesses each, started after phase 2 beside the card's
               phases and waited for here; then qwen3-1.7b's prefill_32k,
               decode_32k and train_4k cells (launch/cells.py) run for real
               at full width and depth in bf16, cut in batch only (32 -> 1,
               128 -> 8, 256 -> 2), each step eager (median of 3 after a
               warm-up) and captured (CellStep: a warm-up, a real step, the
               capture, then median of 5 replays; the prefill's and
               decode's replays equal to the eager step bit for bit) beside
               its roofline bound, mfu and bound_share, with the capture
               seconds, graph pool and peak memory;
               flash_prefill at S 32768 on layer 0's q/k/v against its plain
               version over query blocks (q_offset), its grid under 65535
 24. times   — each kernel, its plain version and (flash_prefill only) torch's
               SDPA timed on the device with CUDA events (calls queued behind
               a device-side sleep), beside the least time the card could
               take (bytes / 3.35 TB/s, flops / 989 TFLOP/s in bf16 or
               67 TFLOP/s in f32 without tensor cores); the attention
               kernels also at the MoE models' shapes; rwkv6_chunk at one
               layer's call, beside the same work as one-chunk calls, its
               host issue time, and one chunk alone; then at [1, 4096] c 32,
               [1, 12288] c 64 and every (B, S, chunk) of phase 9's serve,
               each with its bound and host issue time
After phase 24 the graphs phases' rows are printed again, one line each and
as one JSON object ("[graphs] json"). The last three lines are the card's
name and power limit, the kernels' JSON record and {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# cuBLAS reads this when CUDA starts; deterministic algorithms (the training
# phase's resume check) need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.priority import BatchLimits  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.data.trace import TraceConfig, build_trace  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from repro_torch.distributed.elastic import elastic_restore, reshard_tree  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ParallelConfig, local_tree, place_tree)
from repro_torch.engine import graphs  # noqa: E402
from repro_torch.engine.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels import build, flash_prefill, ops, ref  # noqa: E402
from repro_torch.launch.cells import (  # noqa: E402
    TRAIN_GRAD_ACCUM, CellStep, build_cell, materialize, use_kernels)
from repro_torch.launch.roofline import PEAK_FLOPS, roofline_row  # noqa: E402
from repro_torch.launch.train import token_stream  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import layernorm  # noqa: E402
from repro_torch.models.param_utils import (  # noqa: E402
    shard_params, tree_flatten, tree_map)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.rwkv6 import _chunk_size, kernel_chunking  # noqa: E402
from repro_torch.models.seq_parallel import (  # noqa: E402
    SeqParallelDenseTransformer, params_from_packed, reshard_cache_from_packed)
from repro_torch.models.transformer import DenseTransformer  # noqa: E402
from repro_torch.planner import PlanExecutor, Planner  # noqa: E402
from repro_torch.serving import Frontend, build_real_engine  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig, adamw_update, init_opt_state, shard_opt_state)
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, TrainStep, loss_and_grads)

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # dense TF32 tensor-core peak
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
# The MoE models route every token to its top-k experts, so a difference
# that reorders two router probabilities changes which experts a token reads,
# and through the capacity ranks which slots of other tokens drop. At random
# init in bf16 that dominates a comparison in which each run routes on its
# own: on qwen3-moe-30b-a3b at 4 layers kernel vs plain measured 5.4e-2
# (prefill) and 5.6e-2 (decode) of the largest logit (this script on an
# H100, 700 W, with full rows), and either path, kernel or plain, lands a
# routing flip at random. So the MoE models are held three ways:
# - in float32, kernel vs plain, at MOE_F32_REL_TOL: granite-moe at full
#   depth measured 7.5e-7 (prefill) and 4.8e-7 (decode), and the PERTURB
#   witness moves the same logits by 2.2e-6 and 1.3e-6 (this script on an
#   H100, 700 W): a factor of ten over kernel vs plain, four over the witness;
# - in bf16, each path against the truth, the float32 model on the same
#   weights with plain attention, its routes replayed (Routes): the kernel
#   path at MOE_TRUTH_REL_TOL, beside the control, the bf16 plain path on the
#   same routes (reported), on ragged rows (their pad rows are routed too,
#   and replayed). The limit is a little over twice the largest reading of
#   either path in this phase: 1.35e-2, granite-moe's kernel decode at 32
#   layers; the kernel measured 0.90-1.17 times the control (this script
#   on an H100, 700 W);
# - in bf16, the kernel path replaying the plain path's routes against it,
#   at MODEL_REL_TOL, as the dense models are held.
# Each path's own routing is reported beside them. granite-moe is also held
# in bf16 at MOE_BF16_LAYERS layers with its own routing (MODEL_REL_TOL),
# as before.
MOE_F32_REL_TOL = 1e-5
MOE_TRUTH_REL_TOL = 3e-2
MOE_BF16_LAYERS = 4
QWEN3_MOE_LAYERS = 4
# The paper's model scale (phases 14-14b): qwen3-moe-30b-a3b at all 48
# layers, qwen2.5-32b at 64 and the internvl2-26b backbone at 48, full width,
# their weights drawn one layer group at a time (init_params' by_layer: the
# whole draw holds a 19-39 GB leaf in float32 beside the bf16 tree). Their
# float32 models do not fit the card at full depth (qwen2.5-32b 131 GB,
# qwen3-moe 122 GB): the two dense ones are held in float32 at
# LARGE_F32_LAYERS layers (full rows, beside the PERTURB witness) to
# MOE_F32_REL_TOL, the f32 limit of every model check of this script, and
# in bf16 at full depth to MODEL_REL_TOL; qwen3-moe in bf16 at 48 layers
# kernel vs plain with the plain path's routes replayed (MODEL_REL_TOL).
LARGE_F32_LAYERS = 4
# gemma3-12b: a prefill past the 1024-token window, then decode steps, against
# one pass over the extended sequence, held in float32 at one 6-layer
# local:global group and reported in bf16 at full depth. GEMMA_PREFILL (the
# extended length) is 9 blocks of 128 for the plain blockwise attention.
GEMMA_PREFILL = 1152
GEMMA_DECODE_STEPS = 4
GEMMA_F32_LAYERS = 6
# The decode steps and the one pass differ only in the order of float32 sums:
# measured 3.1e-7 of the largest logit (this script on an H100, 700 W), so the
# limit leaves a factor of thirty. bf16 at full depth measured 1.5e-2.
GEMMA_F32_REL_TOL = 1e-5
# gemma3's short serial serve (phase 15): half of the serve trace's relQueries
GEMMA_TRACE = dict(num_relqueries=4)
# hymba-1.5b (phases 16-18): the same window check as gemma3's, in float32 at
# HYMBA_F32_LAYERS layers, where the decode steps and the one pass differ in
# the order of float32 sums and in the scan's chunks (4 tokens over the
# 1148-token prefill, 64 over the 1152-token pass): measured 6.8e-6 of the
# largest logit (this script on an H100, 700 W). In bf16 the two paths round
# differently by the reference's own dtype flow (the prefill sums the causal
# conv in bf16, decode in float32; the reference's own decode departs from
# its one pass as far: tests/test_torch_transformer.py::
# test_hymba_bf16_decode_departs_from_one_pass_as_the_reference_does), and
# random init amplifies that layer by layer: 7.6e-2 at 32 layers (this
# script on an H100, 700 W). So bf16 is held to MODEL_REL_TOL at
# HYMBA_BF16_LAYERS layers and reported at 32, as rwkv6-7b is.
HYMBA_F32_LAYERS = 4
HYMBA_F32_REL_TOL = 1e-5
HYMBA_BF16_LAYERS = 4
# whisper-base (phase 19): Whisper's 30 s window is 1500 encoder frames; rows
# of 1500 and 1104 valid frames, a decoder prompt of 64 tokens and 4 decode
# steps against one pass of the decoder over all 68, float32 at full depth
# held to WHISPER_F32_REL_TOL, bf16 reported
WHISPER_FRAME_LENS = (1500, 1104)
WHISPER_PROMPT = 64
WHISPER_DECODE_STEPS = 4
WHISPER_F32_REL_TOL = 1e-5
# training (phases 20-21): qwen3-1.7b at full width and depth, bf16 params with
# float32 masters, the reference CLI's batch 8 x 128 and lr, 25 steps on one
# batch; the loss must fall below TRAIN_LOSS_DROP of the first step's, the
# reference's own criterion (tests/test_training.py). Then one step of each
# family at full width cut to TRAIN_FAMILY_LAYERS layers.
TRAIN_STEPS = 25
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_LR = 1e-3
TRAIN_LOSS_DROP = 0.8
TRAIN_FAMILIES = ("qwen3-1.7b", "qwen2-0.5b", "granite-moe-3b-a800m",
                  "qwen3-moe-30b-a3b", "rwkv6-7b", "hymba-1.5b", "whisper-base")
TRAIN_FAMILY_LAYERS = 2
# the steps of the 25 traced on the device (first, count)
TRAIN_PROFILE = (20, 2)
# the eager in-place step on the same trees, for comparison: steps run and
# the steps of them traced (first, count)
TRAIN_EAGER_STEPS = 6
TRAIN_EAGER_PROFILE = (2, 2)
# captured replays held against as many eager steps, bit for bit
TRAIN_CHECK_STEPS = 3
# multi-device (phase 22): a one-rank NCCL process group and a (1, 1)
# ("data", "model") DeviceMesh. qwen3-1.7b's sequence-parallel decode is held
# against the single-device decode_step from the same prefill cache, in
# float32 at MD_F32_LAYERS layers (MD_F32_REL_TOL) and in bf16 at full depth
# (MODEL_REL_TOL), for MD_DECODE_STEPS teacher-forced steps; its step is
# timed MD_TIMED_STEPS times beside the single-device step. granite-moe's
# local expert-parallel dispatch is held against moe_dispatch in float32 at
# MD_MOE_F32_LAYERS layers (MOE_F32_REL_TOL) and in bf16 at full depth with
# routes replayed (MODEL_REL_TOL). ZeRO-1 and elastic restore run on
# qwen3-1.7b at full width cut to TRAIN_FAMILY_LAYERS layers. A one-rank mesh
# checks placements on the card and that every collective reaches NCCL and
# returns, not cross-rank arithmetic (tests/test_torch_layers.py holds that
# on 8 gloo ranks on the CPU).
MD_DECODE_STEPS = 4
MD_F32_LAYERS = 4
MD_F32_REL_TOL = 1e-5
MD_MOE_F32_LAYERS = 4
MD_TIMED_STEPS = 10
MD_CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_md_ckpt")
# the checkpoint of the training phase (params and optimizer state, ~28 GB)
# lives under the checkout's git-ignored build directory, and is removed
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_ckpt")
# each profile phase traces this window of a serve's batches (first, count)
# on the device only, and the serve stops after it: summing a whole serve's
# trace took most of a profile phase's time (the four whole-serve profiles
# ~510 s of a 807 s run on an H100, 700 W, before they were windowed; 8-33 s
# a window of 16 batches in this script's run on an H100, 700 W, before the
# graphed and eager windows doubled their number)
PROFILE_WINDOW = (4, 8)
# the CUDA runtime and driver calls that put work on a stream, as the
# profiler names them: a host launch each (a graph's replay is one)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
# graphs against eager steps (phase_graphs): the serve trace with every
# relQuery arriving at once, so that the batches follow from the trace alone
# and both serve the same batches
GRAPH_TRACE = dict(rate=1e9)
# one prefill (B rows of GRAPH_CHECK_LEN tokens, ragged) and one decode step
# of each model captured beside the same step called eagerly
GRAPH_CHECK_LEN = 128
# phase_graphs' rows, printed together at the end
GRAPH_ROWS: list = []
# the tensor-parallel forward and the cells (phase 23). On the (1, 1) NCCL
# mesh the TP forward of qwen3-1.7b (and granite-moe-3b-a800m, routes
# replayed) is held against the single-device path: prefill and decode
# logits, the train loss and its gradients, in float32 at TP_F32_LAYERS
# layers (logits and loss to TP_F32_REL_TOL of the largest, gradients to
# TP_GRAD_REL_TOL of each leaf's largest) and in bf16 at full depth
# (MODEL_REL_TOL). One rank: every collective is a one-rank NCCL call, so the
# two paths do the same arithmetic, in places in another form (the masked
# vocab lookup, the local shards' products); tests/test_torch_layers.py
# holds the cross-rank arithmetic on 8 gloo ranks.
TP_F32_LAYERS = 4
TP_F32_REL_TOL = 1e-6
TP_GRAD_REL_TOL = 1e-5
# the other families' TP forward on the same mesh: float32 at TP_F32_LAYERS
# (whisper at its full 6 + 6 layers) and bf16 at full depth; rwkv6's
# prefill runs rwkv6_chunk on the rank's WKV heads (all 64 on one rank)
TP_FAMILIES = ("rwkv6-7b", "hymba-1.5b", "whisper-base")
# hymba's bf16 gradients on the TP path sum the attention's and the Mamba
# branch's parts of each layer's input in another order than one device's
# autograd does (3.75e-2 of a leaf's largest at 32 layers of the smoke
# width, on the CPU): at full depth they are reported, in float32 held
TP_BF16_GRADS_REPORTED = ("hymba-1.5b",)
# each run of the TP check prefills twice and times the second (the first
# takes a model's first-call costs)
TP_PREFILLS = 2
# the fully sharded (train_layout "fsdp") and compressed-gradient train
# steps on the same mesh against the same cells' steps on one device:
# (arch, layers) at full width, batch TRAIN_BATCH x TRAIN_SEQ
TP_TRAIN = (("qwen3-1.7b", 4), ("rwkv6-7b", 2))
# qwen3-1.7b's cells run for real at full width and depth in bf16, each cut
# only where one card's 80 GB forces it: (name, seq_len, batch, the cut)
CELL_ARCH = "qwen3-1.7b"
CELLS = (("prefill_32k", 32768, 1, "batch 32 -> 1"),
         ("decode_32k", 32768, 8, "batch 128 -> 8"),
         ("train_4k", 4096, 2, "batch 256 -> 2 (grad_accum 2 kept)"))
CELL_STEPS = 5
# eager steps of each cell timed after its warm-up: fewer than the replays,
# since an eager train_4k step takes ~10 s of host time
CELL_EAGER_STEPS = 3
# flash_prefill at S = 32768 against its plain version, evaluated over query
# blocks of FLASH_BLOCK rows with q_offset (32768^2 scores at once would not
# fit): each block at the bf16 tolerance and, since a late block's outputs
# (averages over up to 32768 values) lie below that tolerance, to the f32
# result rounded once (assert_rounded_once's limit). The grid's y dimension
# must stay under CUDA's 65535
FLASH_BLOCK = 1024
GRID_Y_MAX = 65535
# the production meshes' dry run, in a subprocess (every row ok, or skipped
# where supports_shape says so)
DRYRUN_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m", "rwkv6-7b", "hymba-1.5b",
                "whisper-base")

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


# (B, S, chunk) of one rwkv6-7b layer's WKV call timed beside the serve's own
RWKV_TIME_SHAPES = [(1, 256, 16), (1, 4096, 32), (1, 12288, 64)]

RWKV_LAYER_CASES = [   # (label, input kwargs, chunk, lens): one launch per layer
    ("layer [1,256,64,64] bf16", {"dtype": torch.bfloat16}, 16, None),
    ("max_len [1,1024] bf16", {"dtype": torch.bfloat16, "S": 1024}, 16, None),
    ("bucket [1,4096] bf16", {"dtype": torch.bfloat16, "S": 4096}, 32, None),
    ("[2,128] row 1 padded from 77", {"dtype": torch.bfloat16, "B": 2,
                                      "S": 128}, 16, [128, 77]),
    ("[4,512] views cut from wider projections",
     {"dtype": torch.bfloat16, "B": 4, "S": 512, "cut": True}, 16, None),
    ("all f32 [1,256]", {"dtype": torch.float32}, 16, None),
    ("192 chunks [1,12288]", {"dtype": torch.bfloat16, "S": 12288}, 64, None),
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
        f"torch {torch.__version__} cuda {torch.version.cuda}  memory "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")   # wgmma, TMA loads, mma.sync


def sass_counts(path) -> dict | None:
    """Lines of a library's SASS that hold each of SASS_OPS (HGMMA is no
    substring of HMMA, nor the reverse), from the toolkit's cuobjdump; None
    where the toolkit has none."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return None
    lines = res.stdout.splitlines()
    return {op: sum(op in line for line in lines) for op in SASS_OPS}


def occupancy(name: str) -> list:
    """The library's own query (``<name>_occupancy``) of each kernel
    instance the paths launch: registers, shared memory, threads, resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = getattr(build.load(name), f"{name}_occupancy")
    fn.argtypes = ([ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
                   + [ctypes.POINTER(ctypes.c_int)] * 4)
    fn.restype = ctypes.c_int
    out = []
    while True:
        label = ctypes.create_string_buffer(128)
        vals = [ctypes.c_int(0) for _ in range(4)]
        rc = fn(len(out), label, 128, *[ctypes.byref(x) for x in vals])
        if rc == -1:
            return out
        check(rc == 0, f"{name}'s occupancy query {len(out)}: CUDA error {rc}")
        out.append(dict(zip(("label", "registers", "smem", "threads",
                             "blocks_per_sm"),
                            [label.value.decode()] + [x.value for x in vals])))


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f}s "
        f"(flags: {' '.join(build.NVCC_FLAGS)})")
    for b in built.values():
        log(f"[build] {b.name}: {b.path.relative_to(build.BUILD_DIR.parents[1])} "
            f"({b.seconds:.2f}s)")
        for line in b.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "arning")):
                log(f"[build]   {line.strip()}")
    for b in built.values():
        n = sass_counts(b.path)
        log(f"[build] {b.name}: SASS lines with "
            + ("not measured (no cuobjdump)" if n is None else
               ", ".join(f"{op} {n[op]}" for op in SASS_OPS)))
        # every kernel loads its tiles by TMA; flash_prefill's products run
        # on wgmma (HGMMA), which a count of HMMA would not see; rwkv6_chunk's
        # A v, k^T v and r~ S on mma.sync (HMMA)
        if b.name == "flash_prefill" and n is not None:
            check(n["HGMMA"] > 0, "flash_prefill's library has no wgmma "
                                  "instruction (HGMMA)")
        if b.name == "rwkv6_chunk" and n is not None:
            check(n["HMMA"] > 0, "rwkv6_chunk's library has no mma.sync "
                                 "instruction (HMMA)")
        if n is not None:
            check(n["UTMALDG"] > 0, f"{b.name}'s library has no TMA load "
                                    f"(UTMALDG)")
        for inst in occupancy(b.name):
            log(f"[build] {b.name} [{inst['label']}]: {inst['registers']} "
                f"registers, {inst['smem']} bytes of shared memory, "
                f"{inst['threads']} threads, {inst['blocks_per_sm']} blocks "
                f"per SM")
            check(inst["blocks_per_sm"] > 0, f"{b.name} [{inst['label']}] "
                  f"fits no block on an SM")


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
    shape_kernel_checks()
    errs["rwkv6_chunk"] = rwkv_kernel_checks()
    rwkv_chunking_checks()
    return errs


# the other paged models' attention shapes: (label, kv slots, q rows per
# slot, head_dim)
ATTN_SHAPES = [("granite-moe KV 8 Qp 3 hd 64", 8, 3, 64),
               ("qwen3-moe KV 4 Qp 8 hd 128", 4, 8, 128),
               ("qwen2.5-32b KV 8 Qp 5 hd 128", 8, 5, 128),
               ("internvl2-26b KV 8 Qp 6 hd 128", 8, 6, 128)]


def shape_kernel_checks() -> None:
    """Both attention kernels at the other paged models' shapes, which the
    qwen3-1.7b inputs do not take: granite-moe's 3 q rows per kv slot at
    head_dim 64 (the paged kernel's 4-row path with a pad row; prefill tiles
    that end inside a position), qwen3-moe's 8 rows, qwen2.5-32b's 5 and
    internvl2-26b's 6 at head_dim 128 (2 rows per lane group, with a pad
    row at Qp 5; prefill row groups of 64 ending inside a position); decode
    over the serve's
    pool of 16-token pages, prefill [4, G, 512, R, hd] causal."""
    log("[kernels] paged_attention and flash_prefill at the other paged "
        "models' shapes")
    for dtype in (torch.bfloat16, torch.float32):
        for label, KV, R, hd in ATTN_SHAPES:
            args = paged_inputs(dtype, KV=KV, Qp=R, hd=hd)
            out = ops.paged_attention(*args)
            want = ref.paged_attention_ref(*args)
            torch.cuda.synchronize()
            assert_close("paged_attention", out, want, dtype, label)
            if dtype == torch.bfloat16:
                assert_rounded_once("paged_attention", out,
                                    ref.paged_attention_ref(*upcast(args)), label)
            q, k, v = prefill_inputs(dtype, G=KV, R=R, hd=hd)
            out = ops.flash_prefill(q, k, v, causal=True)
            want = ref.flash_prefill_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            assert_close("flash_prefill", out, want, dtype, label)
            if dtype == torch.bfloat16:
                assert_rounded_once("flash_prefill", out, ref.flash_prefill_ref(
                    *upcast((q, k, v)), causal=True), label)


def rwkv_chunking_checks() -> None:
    """ROADMAP fault 3: sequence lengths whose reference chunk length the
    kernel does not take (S 1000: 8; S 12288: 96). One rwkv6-7b layer's WKV
    call through the model's own path (``RWKV6Model._wkv``: one launch at a
    chunk length the kernel takes, S 1000 padded to 1008) against the plain
    version at the reference's chunk length, at RWKV_CHAIN_TOL."""
    model = build_model(get_config("rwkv6-7b")).with_wkv_impl("kernel")
    for S in (1000, 12288):
        args = rwkv_layer_inputs(torch.bfloat16, S=S)
        c = _chunk_size(S)
        before = ops.launch_counts()["rwkv6_chunk"]
        o, s = model._wkv(*args, chunk=c)
        check(ops.launch_counts()["rwkv6_chunk"] == before + 1,
              f"S={S}: the model's WKV call is not one launch")
        want_o, want_s = ref.rwkv6_chunk_plain(*args, out_dtype=torch.float32,
                                               chunk=c)
        label = (f"model path S={S} (reference chunk {c}; kernel chunk, "
                 f"padded length {kernel_chunking(S)})")
        assert_chain_close(f"o {label}", o, want_o)
        assert_chain_close(f"state {label}", s, want_s)


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
        log(f"  {name} {label}: one call vs {args[0].shape[1] // chunk} "
            f"chained one-chunk calls: o {max_err(o, chain_o):.3e}, state "
            f"{max_err(s, chain_s):.3e} (bit for bit)")
        check(torch.equal(o, chain_o) and torch.equal(s, chain_s),
              f"{name} {label}: one call differs from chained one-chunk calls")
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


def full_model(arch: str, dtype: str = "", device="cuda", layers: int = 0,
               by_layer: bool = False):
    """Full-width config (in ``dtype``, at ``layers`` layers if given), model
    and random weights from SEED (``by_layer``: drawn one layer group at a
    time, the init the 20-33B models need to fit the card)."""
    cfg = get_config(arch)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(SEED),
                               by_layer=by_layer)
    return cfg, model, params


def first_layers(model, params, n: int):
    """The model and parameter tree cut to its first ``n`` layers (views)."""
    groups = n // model.group
    return (model.with_layers(n),
            dict(params, blocks={k: v[:groups]
                                 for k, v in params["blocks"].items()}))


def perturbed_attention(model, device="cuda"):
    """The plain-attention model with every attention output, prefill and
    decode, multiplied by (1 + PERTURB * randn) in float32 before the output
    projection: the model's own sensitivity to last-bit noise (float32 models
    only: a bf16 output rounds the perturbation away)."""
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    m = model.with_prefill_attn("block")
    inner = m._attn_out

    def attn_out(o, wo):
        noise = torch.randn(o.shape, generator=g, device=o.device)
        return inner((o.float() * (1 + PERTURB * noise)).to(o.dtype), wo)

    m._attn_out = attn_out
    return m


def log_rel(tag: str, what: str, got, want, tol, witness=None) -> float:
    """Log kernel-vs-plain logits relative to the largest |logit| (and the
    witness's, if given); hold them to ``tol`` unless it is None. Returns
    the relative error."""
    scale = float(want.float().abs().max())
    rel = max_err(got, want) / scale
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    wit = "" if witness is None else (
        f"; plain with its attention outputs perturbed by {PERTURB:g}: rel "
        f"{max_err(witness, want) / scale:.3e}")
    log(f"[{tag}] {what}: logits max_abs_err {max_err(got, want):.3e} (max "
        f"|logit| {scale:.3e}, rel {rel:.3e}, tol "
        f"{'reported only' if tol is None else f'{tol:g}'}){wit}; argmax "
        f"agreement {same:.2f}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite logits")
    if tol is not None:
        check(rel <= tol, f"{what}: kernel vs plain disagree")
    return rel


# The MoE models' comparisons in which each path routes on its own take full
# rows: a pad row is routed like any other token and takes expert capacity,
# and the flash path leaves pad rows unmasked (a dense model never reads
# them) where the blockwise path masks them, so with ragged rows the two
# paths drop different slots, as they do in the reference (granite-moe, f32,
# 32 layers, ragged rows: kernel vs plain 7.4e-2 of the largest logit, the
# PERTURB witness 1.8e-6; this script on an H100, 700 W). With routes
# replayed (phase_model_truth) the pad rows' slots are the recorded ones, so
# those comparisons take ragged rows.
FULL_ROWS = (128, 128, 128, 128)


def paged_pools(model, caches, lens, L, bs=16, device="cuda"):
    """Paged pools holding a prefill's ``caches`` (rows of ``lens`` tokens,
    padded to ``L``) and the rows' block tables, with room for one decode
    step: it writes position seq_len, so a full row needs one more block."""
    B, nblk = len(lens), L // bs
    width = nblk + (int(max(lens)) == L)
    pools = model.init_paged_pools(B * width + 1, bs, device)
    tables = torch.arange(B * width, dtype=torch.int32,
                          device=device).reshape(B, width)
    model.scatter_prefill_pools(pools, caches, tables[:, :nblk])
    return pools, tables


def phase_model_paged(cfg, model, params, tol=MODEL_REL_TOL, witness=False,
                      lens=(120, 97, 64, 33), device="cuda") -> None:
    """One prefill batch of rows of ``lens`` tokens (padded to 128) and one
    paged decode step of the full-width model, kernel attention vs the plain
    attention path, on the same inputs, held to ``tol`` of the largest
    |logit| (None: reported only). ``witness``: beside them the plain path
    with its attention outputs perturbed by PERTURB."""
    B, L, bs = len(lens), 128, 16
    what = f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}"
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, L)),
                           dtype=torch.int32, device=device)
    seq_lens = torch.as_tensor(lens, dtype=torch.int32, device=device)
    lg_plain, caches = model.with_prefill_attn("block").prefill(
        params, toks, seq_lens=seq_lens, max_len=L)
    lg_kern, _ = model.with_prefill_attn("flash").prefill(
        params, toks, seq_lens=seq_lens, max_len=L)
    pert = perturbed_attention(model, device) if witness else None
    lg_wit = None
    if witness:
        lg_wit, _ = pert.prefill(params, toks, seq_lens=seq_lens, max_len=L)
    log_rel("model", f"{what} prefill B={B} L={L}", lg_kern, lg_plain, tol,
            lg_wit)

    pools, tables = paged_pools(model, caches, lens, L, bs, device)
    copies = [{k: v.clone() for k, v in pools.items()} for _ in range(2)]
    tokens = lg_plain.argmax(-1).to(torch.int32)
    positions = seq_lens.clone()
    ctx = positions + 1
    d_kern, _ = model.decode_step_paged(params, pools, tokens, positions, tables,
                                        ctx, attn_impl="kernel")
    d_plain, _ = model.decode_step_paged(params, copies[0], tokens, positions,
                                         tables, ctx, attn_impl="ref")
    d_wit = None
    if witness:
        d_wit, _ = pert.decode_step_paged(params, copies[1], tokens, positions,
                                          tables, ctx, attn_impl="ref")
    log_rel("model", f"{what} paged decode B={B}", d_kern, d_plain, tol, d_wit)


class Routes:
    """The MoE layers' expert choices, recorded in one run (``record``) and
    replayed in another (``replay``). A replaying run sends each token to the
    recorded experts and drops the recorded slots, weighted by its own router
    probabilities at those experts, renormalised as ``moe_route`` does. Its
    difference to the recorded run then stays continuous, as in a dense
    model: no rounding difference flips a token's experts."""

    def __init__(self):
        self.routes = []

    @staticmethod
    @contextlib.contextmanager
    def _patched(fn):
        inner = moe.moe_route
        moe.moe_route = fn
        try:
            yield
        finally:
            moe.moe_route = inner

    def record(self):
        inner = moe.moe_route

        def rec(*args, **kw):
            rt = inner(*args, **kw)
            self.routes.append(rt)
            return rt
        return self._patched(rec)

    @contextlib.contextmanager
    def replay(self):
        it = iter(self.routes)

        def rep(x, router_w, num_padded, **kw):
            rt = next(it)
            check(rt.top_i.shape[0] == x.shape[0], "replayed a route of "
                  "another batch")
            probs = torch.softmax((x @ router_w).float(), dim=-1)
            w = probs.gather(1, rt.top_i)
            # the aux loss on the recorded first choices and this run's
            # probabilities: moe_route's value, differentiable in this run
            E = probs.shape[1]
            frac = (rt.top_i[:, :1] == torch.arange(E, device=x.device)).float()
            return rt._replace(
                top_w=w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9),
                aux=E * torch.sum(frac.mean(dim=0) * probs.mean(dim=0)))
        with self._patched(rep):
            yield
        check(next(it, None) is None, "a replay used fewer routes than the "
              "recorded run")


def paged_pass(model, params, toks, seq_lens, kernels: bool, tokens=None,
               route=contextlib.nullcontext):
    """The served path of one batch: a prefill (flash_prefill if
    ``kernels``, else the blockwise plain attention), then one paged decode
    step (paged_attention, else its plain version) from its own caches, of
    ``tokens`` (default: the prefill's greedy tokens); both inside
    ``route()``. Returns (prefill logits, decode logits, decode tokens)."""
    L = toks.shape[1]
    m = model.with_prefill_attn("flash" if kernels else "block")
    with route():
        lg, caches = m.prefill(params, toks, seq_lens=seq_lens, max_len=L)
        if tokens is None:
            tokens = lg.argmax(-1).to(torch.int32)
        pools, tables = paged_pools(m, caches, seq_lens, L,
                                    device=toks.device)
        d, _ = m.decode_step_paged(params, pools, tokens, seq_lens, tables,
                                   seq_lens + 1,
                                   attn_impl="kernel" if kernels else "ref")
    return lg, d, tokens


def tree_float(tree):
    """A float32 copy of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_float(v) for k, v in tree.items()}
    return tree.float()


def phase_model_truth(cfg, model, params, truth_tol, replay_tol,
                      lens=(120, 97, 64, 33), device="cuda",
                      with_truth: bool = True) -> None:
    """A bf16 MoE model's served path (paged_pass) against the truth: the
    float32 model on the same weights (the bf16 values upcast) with plain
    attention. Beside the kernel path, the control: the bf16 plain path
    against the same truth. Each bf16 path runs with its own routing and
    replaying the truth's expert choices (Routes). Held, to a share of the
    largest |logit| (None: reported only): the kernel path replaying the
    truth's routes, to ``truth_tol``; the kernel path replaying the bf16
    plain path's routes against that path, to ``replay_tol``. Reported: the
    rest, kernel vs plain with their own routing among them.
    ``with_truth`` False (a model whose float32 copy does not fit the
    card): the plain path and the kernel path only, the decode on the
    plain path's greedy tokens."""
    what = f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}"
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(len(lens), 128)),
                           dtype=torch.int32, device=device)
    seq_lens = torch.as_tensor(lens, dtype=torch.int32, device=device)
    truth_routes, plain_routes = Routes(), Routes()
    tokens = None
    with torch.no_grad():
        if with_truth:
            m32 = build_model(cfg.replace(dtype="float32"))
            p32 = tree_float(params)
            truth = paged_pass(m32, p32, toks, seq_lens, False,
                               route=truth_routes.record)
            del m32, p32
            free()
            tokens = truth[2]
        plain = paged_pass(model, params, toks, seq_lens, False, tokens,
                           plain_routes.record)
        tokens = plain[2]
        kern = paged_pass(model, params, toks, seq_lens, True, tokens)
        kern_rp = paged_pass(model, params, toks, seq_lens, True, tokens,
                             plain_routes.replay)
        if with_truth:
            kern_rt = paged_pass(model, params, toks, seq_lens, True, tokens,
                                 truth_routes.replay)
            plain_rt = paged_pass(model, params, toks, seq_lens, False,
                                  tokens, truth_routes.replay)
    for i, step in enumerate(("prefill", "paged decode")):
        log_rel("moe", f"{what} {step}: kernel vs plain, own routes",
                kern[i], plain[i], None)
        log_rel("moe", f"{what} {step}: kernel replaying plain's routes vs "
                f"plain", kern_rp[i], plain[i], replay_tol)
        if not with_truth:
            continue
        log_rel("moe", f"{what} {step}: kernel vs f32 truth, own routes",
                kern[i], truth[i], None)
        log_rel("moe", f"{what} {step}: control, plain vs f32 truth, own "
                f"routes", plain[i], truth[i], None)
        log_rel("moe", f"{what} {step}: kernel replaying truth's routes vs "
                f"f32 truth", kern_rt[i], truth[i], truth_tol)
        log_rel("moe", f"{what} {step}: control, plain replaying truth's "
                f"routes vs f32 truth", plain_rt[i], truth[i], None)


def phase_model_window(cfg, model, params, tol, device="cuda") -> None:
    """A ragged prefill past the 1024-token window (rows of 1148 and 1090
    tokens: every window ring wraps), then GEMMA_DECODE_STEPS decode steps
    from its caches, teacher-forced, each against the same row and position
    of one causal pass over the whole extended sequence; held to ``tol`` of
    the largest |logit| (None: reported only). No kernel is on this path, as
    in the reference: it holds the ring-buffer caches (gemma3) and, for
    hymba, the conv tail and SSM state after a padded row."""
    B, steps = 2, GEMMA_DECODE_STEPS
    n = GEMMA_PREFILL - steps
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, n + steps)),
                           dtype=torch.int32, device=device)
    lens = torch.as_tensor([n, n - 58], dtype=torch.int32, device=device)
    check(int(lens.min()) > cfg.sliding_window, "rows do not pass the window")
    rows = torch.arange(B, device=device)
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :n], seq_lens=lens,
                                 max_len=n + steps)
        got = []
        for j in range(steps):
            d, cache = model.decode_step(params, cache, toks[rows, lens + j],
                                         lens + j)
            got.append(d)
        S = n + steps
        hidden, _, _ = model.forward_hidden(
            params, model.embed_tokens(params, toks),
            torch.arange(S, dtype=torch.int32, device=device).expand(B, S))
        want = [model.logits(params, hidden[rows, (lens + j).long()])
                for j in range(steps)]
    what = (f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}: prefill of "
            f"[{n}, {n - 58}] tokens (window {cfg.sliding_window}), decode "
            f"steps vs one pass over the extended sequence")
    tag = f"{cfg.name.split('-')[0]} model"
    worst = max(log_rel(tag, f"{what}, step {j}", got[j], want[j], tol)
                for j in range(steps))
    log(f"[{tag}] {what}: worst rel {worst:.3e}")


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


# (kv backend, max_slots, kernels its serve must launch) of each path's serve;
# rwkv6-7b runs with as many slots as layers on purpose (a slot axis found by
# its size would be wrong); gemma3's window layers and hymba's take the dense
# backend only, whose attention is plain, as in the reference. The 20-33B
# models take 16 slots: the paged pool holds max(max_slots x max_len, the
# scheduler's cap of 16384 tokens + 256 sequences of rounding) / 16 blocks
# (serving/factory.py), so any count up to 20 leaves it at the cap's 1280
# blocks + scratch (5.00 GiB of KV at qwen2.5-32b's 256 KiB per token, 3.75
# at internvl2-26b's 192, 1.88 at qwen3-moe's 96) beside 61.03, 36.99 and
# 56.87 GiB of bf16 weights. qwen3's 64 slots would make qwen2.5-32b's pool
# 16 GiB: 77 GiB before the first prefill batch, on a card of 80 GB (phase
# 1 logs what torch sees of it)
BOTH = ("paged_attention", "flash_prefill")
SERVE = {"qwen3-1.7b": ("paged", 64, BOTH),
         "rwkv6-7b": ("dense", 32, ("rwkv6_chunk",)),
         "granite-moe-3b-a800m": ("paged", 64, BOTH),
         "qwen3-moe-30b-a3b": ("paged", 16, BOTH),
         "qwen2.5-32b": ("paged", 16, BOTH),
         "internvl2-26b": ("paged", 16, BOTH),
         "gemma3-12b": ("dense", 32, ()),
         "hymba-1.5b": ("dense", 32, ())}


def serve_engine(model, params, loop: str, device="cuda", eager=False):
    """The engine of this path's serve (SERVE): CUDA graphs per shape
    bucket, or eager steps with ``eager``."""
    arch = model.cfg.name
    backend, max_slots, _ = SERVE[arch]
    return build_real_engine(arch, "relserve", backend, model=copy.copy(model),
                             params=params, max_slots=max_slots, max_len=1024,
                             engine_loop=loop, device=device, eager=eager)


def graph_stats(ex, device="cuda") -> dict:
    """The executor's graphs, their capture seconds (prestage's apart), its
    graph pool's bytes, and the peak max_memory_allocated since the last
    reset."""
    cuda = device == "cuda"
    return {"graphs": ex.num_graphs, "capture_s": ex.capture_s,
            "prestage_s": ex.prestage_compile_s,
            "pool_bytes": ex.pool_bytes() if cuda else None,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def gib(n) -> str:
    return "not measured" if n is None else f"{n / 2**30:.2f} GiB"


def graphs_line(g: dict) -> str:
    return (f"{g['graphs']} graphs, capture {g['capture_s']:.2f}s (prestage "
            f"{g['prestage_s']:.2f}s), graph pool {gib(g['pool_bytes'])}, "
            f"peak max_memory_allocated {gib(g['peak_bytes'])}")


def run_serve(model, params, trace, loop: str, device="cuda", card: str = "",
              on_engine=None, eager=False) -> dict:
    """Serve ``trace`` (CUDA graphs per bucket; eager steps with ``eager``).
    Returns its token streams, the executor's prefill calls and decode steps
    (a graph's replay calls no model function, so the executor counts
    them), the wall and ``graph_stats``. ``on_engine`` gets the engine
    before the serve starts."""
    arch = model.cfg.name
    backend, max_slots, _ = SERVE[arch]
    trace = copy.deepcopy(trace)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine = serve_engine(model, params, loop, device, eager)
    ex = engine.executor
    if on_engine is not None:
        on_engine(engine)
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
    run = {"streams": [tuple(r.output_tokens) for rq in trace
                       for r in rq.requests],
           "prefills": ex.prefill_calls, "steps": len(ex.decode_samples),
           "wall": wall, "batches": len(report.events),
           "buckets": {k: s.calls for k, s in ex._prefill_fn.items()},
           "decode_keys": list(ex._decode_fn) if backend == "paged" else [],
           **graph_stats(ex, device)}
    log(f"[serve] {arch} {backend} {loop} {'eager' if eager else 'graphed'}: "
        f"{len(report.latencies)} relQueries, "
        f"{sum(len(rq.requests) for rq in trace)} requests, {n_tok} tokens; "
        f"latency avg {report.avg_latency:.4f}s p50 {report.percentile(50):.4f}s "
        f"p99 {report.percentile(99):.4f}s; wall {wall:.3f}s, "
        f"{n_tok / wall:.1f} tokens/s; {run['batches']} batches, "
        f"{run['prefills']} prefill calls, {run['steps']} decode steps; "
        f"{where}; {graphs_line(run)}; fitted alpha_p {fitted.alpha_p:.3e} "
        f"beta_p {fitted.beta_p:.3e} alpha_d {fitted.alpha_d:.3e} "
        f"beta_d {fitted.beta_d:.3e}; {card}")
    del engine, ex
    if device == "cuda":
        free()
    return run


def check_serve_launches(cfg, got: dict, run: dict, label: str) -> None:
    """Each kernel of this path's serve (SERVE) launched once per layer per
    prefill call or decode step of ``run``, every other kernel never."""
    _, _, kernels = SERVE[cfg.name]
    per = {"paged_attention": run["steps"], "flash_prefill": run["prefills"],
           "rwkv6_chunk": run["prefills"]}
    log(f"[serve] {cfg.name} {label} launches: {got}; per layer and "
        f"call: " + ", ".join(
            f"{name} {got[name] / max(per[name] * cfg.num_layers, 1):g} "
            f"({per[name]} calls x {cfg.num_layers} layers)"
            for name in kernels))
    for name in got:
        want = per[name] * cfg.num_layers if name in kernels else 0
        check(got[name] == want and (want > 0 or name not in kernels),
              f"{label} serve launched {name} {got[name]} times, not "
              f"{want} (one per layer per call of this path)")


def phase_serve(model, params, *, exact: bool = False, loops=("serial",
                                                               "pipelined"),
                trace_kw=None, device="cuda",
                rwkv_shapes: collections.Counter | None = None) -> dict:
    """The serve of this path in each of ``loops``, through CUDA graphs;
    each must launch the kernels of this path's own serve (SERVE), one
    launch per layer per prefill call or decode step, and a path without
    kernels must launch none. ``exact``: the loops' streams must be
    identical (else the share that is is reported). ``rwkv_shapes`` gets the
    (B, S, chunk) counts of the serves' rwkv6_chunk calls. Returns this
    path's launch counts."""
    card = nvidia_smi_line() if device == "cuda" else "cpu"
    cfg = model.cfg
    trace = serve_trace(cfg.vocab_size - 2, **(trace_kw or {}))
    ops.reset_launch_counts()
    runs = []
    for loop in loops:
        before = ops.launch_counts()
        run = run_serve(model, params, trace, loop, device, card)
        after = ops.launch_counts()
        check_serve_launches(cfg, {name: after[name] - before[name]
                                   for name in after}, run, loop)
        runs.append(run)
    counts = ops.launch_counts()
    if len(runs) == 2:
        a, b = (r["streams"] for r in runs)
        same = sum(x == y for x, y in zip(a, b)) / len(a)
        log(f"[serve] {cfg.name} identical streams serial vs pipelined: "
            f"{same:.3f} ({card})")
        if exact:
            check(a == b, "serial and pipelined streams differ")
    if device == "cuda":
        log(f"[serve] {cfg.name} peak torch.cuda.max_memory_allocated over "
            f"the serves: {gib(max(r['peak_bytes'] for r in runs))}")
    if rwkv_shapes is not None:
        # every prefill step of the dense executor is one sequence of its
        # bucket, through rwkv6_chunk once per layer at kernel_chunking's
        # chunk and padded length
        for run in runs:
            for S, calls in run["buckets"].items():
                c, padded = kernel_chunking(S)
                rwkv_shapes[(1, padded, c)] += calls * cfg.num_layers
    return {name: counts[name] for name in build.KERNELS}


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


SWAP_HOOKS = {"swap_out": "swap-outs", "swap_in": "swap-ins",
              "prefetch_swap_in": "prefetches",
              "cancel_swap_prefetch": "prefetch cancels"}


def watch_swaps(ex) -> dict:
    """Time the executor's swap hooks on the host: for each hook its calls,
    host seconds and the MB (1e6 bytes) of KV of the stashes it moved.
    Returns the dict the wrappers fill in."""
    stats = {hook: {"calls": 0, "s": 0.0, "mb": 0.0} for hook in SWAP_HOOKS}

    def mb(req_id):
        entry = ex._host_stash.get(req_id)
        return 0.0 if entry is None else sum(
            x.numel() * x.element_size() for x in entry[-1].values()) / 1e6

    for hook in SWAP_HOOKS:
        def timed(req_id, tokens, inner=getattr(ex, hook), st=stats[hook],
                  out=hook == "swap_out", back=hook.endswith("swap_in")):
            moved = mb(req_id) if back else 0.0
            t0 = time.perf_counter()
            extra = inner(req_id, tokens)
            st["s"] += time.perf_counter() - t0
            st["calls"] += 1
            st["mb"] += mb(req_id) if out else moved
            return extra
        setattr(ex, hook, timed)
    return stats


def swaps_line(stats: dict, cow: int, wall: float) -> str:
    """The hooks' calls, MB and host seconds, their host seconds per MB
    moved (the cancels move nothing) and their share of a serve's ``wall``
    seconds."""
    parts = [f"{st['calls']} {SWAP_HOOKS[h]} ({st['mb']:.1f} MB, "
             f"{st['s'] * 1e3:.3f} ms host)" for h, st in stats.items()]
    mb = sum(st["mb"] for st in stats.values())
    sec = sum(st["s"] for st in stats.values())
    per = f"{sec / mb * 1e3:.4f} ms of host per MB" if mb else "no MB moved"
    return (f"{', '.join(parts)}, {cow} copy-on-write copies; {per}, "
            f"{sec / wall:.4f} of the serve's wall")


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
                card: str = "", on_engine=None) -> tuple:
    """Replay ``trace`` through the planner (dedup + prefix-maximizing
    reorder) on the tight-cap, prefix-shared, KV-tiered paged engine and
    check it; the swap hooks are timed on the host (watch_swaps). Returns
    every logical row's stream, in trace order, and the steps the serve
    captured (``precapture``'s ``run``). ``on_engine`` gets the engine
    before the replay starts."""
    trace = copy.deepcopy(trace)
    engine = planned_engine(model, params, loop, cap, device)
    if on_engine is not None:
        on_engine(engine)
    ex = engine.executor
    bad_cow: list = []
    watch_cow(ex, bad_cow)
    swaps = watch_swaps(ex)
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
    check(swaps["swap_out"]["calls"] == report.swap_outs
          and swaps["swap_in"]["calls"] == report.swap_ins,
          f"planned {loop}: the executor's swap hooks ran "
          f"{swaps['swap_out']['calls']} swap-outs and "
          f"{swaps['swap_in']['calls']} swap-ins")
    log(f"[planned] swap hooks {loop}: "
        f"{swaps_line(swaps, ex.cow_copies, wall)}; {card}")
    streams = [tuple(r.output_tokens) for r in rows]
    steps = {"buckets": dict.fromkeys(ex._prefill_fn),
             "decode_keys": list(ex._decode_fn), "cow": ex._copy_fn is not None}
    del engine, ex
    if device == "cuda":
        torch.cuda.empty_cache()
    return streams, steps


def phase_planned(model, params, device="cuda") -> tuple:
    """The planned, prefix-shared, KV-tiered serve, serial then pipelined;
    each loop must launch both attention kernels. Then the same engine
    serves the trace unplanned, and the share of rows whose streams match is
    reported (not checked: in bf16 another batch composition may change a
    greedy token). Returns the two loops' launch counts and the steps both
    loops captured (to warm the planned profile window)."""
    card = nvidia_smi_line() if device == "cuda" else "cpu"
    trace = serve_trace(model.cfg.vocab_size - 2, **PLANNED_TRACE)
    cap = planned_cap(trace)
    ops.reset_launch_counts()
    serial, warm = run_planned(model, params, trace, "serial", cap, device, card)
    after_serial = ops.launch_counts()
    pipelined, more = run_planned(model, params, trace, "pipelined", cap,
                                  device, card)
    counts = ops.launch_counts()
    warm = {"buckets": {**warm["buckets"], **more["buckets"]},
            "decode_keys": list(dict.fromkeys(warm["decode_keys"]
                                              + more["decode_keys"])),
            "cow": warm["cow"] or more["cow"]}
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
    return {name: counts[name] for name in model.KERNELS}, warm


def host_issue_ms(fn, n: int = 20) -> float:
    """Host time to issue one call (no synchronize inside the loop): for a
    kernel, the wrapper's checks, allocations, and (the attention kernels)
    the encoding of its tensor maps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issue = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return issue


def time_paged(dt, label: str, **shape) -> dict:
    """paged_attention at the phase-3 decode inputs of ``shape``: kernel,
    plain and bound (bytes: q read and out written once, K and V of every
    context token, the table entries read, the lengths)."""
    esize = torch.finfo(dt).bits // 8
    args = paged_inputs(dt, **shape)
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
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    ms = cuda_time_ms(lambda: ops.paged_attention(*args))
    plain = cuda_time_ms(lambda: ref.paged_attention_ref(*args))
    issue = host_issue_ms(lambda: ops.paged_attention(*args))
    log(f"[times] paged_attention {label} q={list(q.shape)} B={B} "
        f"tokens={tokens}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms (bytes {nbytes}, flops {flops}), library null; host "
        f"issue {issue:.4f} ms per call")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "host_issue_ms": issue}


def time_prefill(dt, label: str, **shape) -> dict:
    """flash_prefill at the phase-3 causal prefill inputs of ``shape``:
    kernel, plain, torch's SDPA and bound (the unmasked (row, key) pairs'
    products; q, k, v read and out written once)."""
    esize = torch.finfo(dt).bits // 8
    q, k, v = prefill_inputs(dt, **shape)
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
    issue = host_issue_ms(lambda: ops.flash_prefill(q, k, v, causal=True))
    log(f"[times] flash_prefill {label} q={list(q.shape)} causal: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{bound:.4f} ms (flops {flops}, bytes {nbytes}); host issue "
        f"{issue:.4f} ms per call (two tensor maps encoded)")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib, "host_issue_ms": issue}


def phase_times(errs: dict, paths: dict, flash_32k: dict,
                rwkv_shapes: collections.Counter) -> list:
    """The kernels' record at the main-path (qwen3-1.7b) inputs of phase 3;
    the attention kernels are also timed at ATTN_SHAPES (``by_shape``),
    rwkv6_chunk at the long buckets and at ``rwkv_shapes``, the (B, S,
    chunk) counts of the rwkv6 serve's calls (``by_shape``).
    ``paths``: each serve's own launch counts (counters set to 0 before it
    and read after it); a record's ``launches`` is their sum and
    ``launches_by_path`` splits it. flash_prefill's record also carries its
    time at S 32768 from the prefill cell (``at_32k``)."""
    def launches(name):
        by_path = {path: got[name] for path, got in paths.items()
                   if name in got}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    out = []
    dt = torch.bfloat16
    for name, timer in (("paged_attention", time_paged),
                        ("flash_prefill", time_prefill)):
        rec = timer(dt, "qwen3-1.7b")
        out.append(dict({"name": name, "route": "cuda", "source": SOURCES[name],
                         "replaces": REPLACES[name], **launches(name),
                         "max_abs_err": errs[name]}, **rec))
        if name == "flash_prefill":
            out[-1]["at_32k"] = flash_32k
        out[-1]["by_shape"] = {
            label: timer(dt, label, **({"KV": KV, "Qp": R, "hd": hd}
                                       if name == "paged_attention"
                                       else {"G": KV, "R": R, "hd": hd}))
            for label, KV, R, hd in ATTN_SHAPES}

    # rwkv6_chunk at one layer's call of the serve: r/k/v bf16 [1, 256, 64,
    # 64] in chunks of 16, logw / u / state f32, o f32
    f32 = torch.float32
    args = rwkv_layer_inputs(torch.bfloat16)
    S, c = args[0].shape[1], 16
    rec = time_rwkv(args, c)
    chained = cuda_time_ms(lambda: chained_launches(*args, c, f32))
    # ~30 launches per chunk: too many to queue ahead of the device
    plain = cuda_time_ms(lambda: ref.rwkv6_chunk_plain(*args, out_dtype=f32,
                                                       chunk=c),
                         iters=5, warmup=1, queued=False)
    one = rwkv_inputs(torch.bfloat16)    # one chunk [1, 16, 64, 64] alone
    one_ms = cuda_time_ms(lambda: ops.rwkv6_chunk(*one, out_dtype=f32))
    log(f"[times] rwkv6_chunk r={list(args[0].shape)} bf16 c={c}, o f32 (one "
        f"layer's call): kernel {rec['ms']:.4f} ms, the same work as {S // c} "
        f"one-chunk calls {chained:.4f} ms, plain {plain:.4f} ms (not queued: "
        f"with the host's gaps), bound {rec['bound_ms']:.4f} ms, library "
        f"null; host issue {rec['host_issue_ms']:.4f} ms per call; one chunk "
        f"r=[1, 16, 64, 64]: {one_ms:.4f} ms")
    # the long buckets, and every (B, S, chunk) the rwkv6 serve called with
    shapes = RWKV_TIME_SHAPES[1:] + sorted(rwkv_shapes)
    by_shape = {}
    for B, Sx, cx in dict.fromkeys(shapes):
        r = time_rwkv(rwkv_layer_inputs(torch.bfloat16, B=B, S=Sx), cx)
        label = f"B={B} S={Sx} c={cx}"
        r["serve_calls"] = rwkv_shapes.get((B, Sx, cx), 0)
        log(f"[times] rwkv6_chunk {label} ({r['serve_calls']} calls in the "
            f"serve): kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), host issue {r['host_issue_ms']:.4f} ms")
        by_shape[label] = r
    out.append({"name": "rwkv6_chunk", "route": "cuda",
                "source": SOURCES["rwkv6_chunk"],
                "replaces": REPLACES["rwkv6_chunk"],
                **launches("rwkv6_chunk"),
                "max_abs_err": errs["rwkv6_chunk"], "ms": rec["ms"],
                "plain_ms": plain, "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "host_issue_ms": rec["host_issue_ms"], "by_shape": by_shape})
    return out


def time_rwkv(args, c: int) -> dict:
    """rwkv6_chunk on ``args`` in chunks of ``c``, o f32: device and host
    issue time per call, and the bound: the bytes of the inputs read and the
    outputs written once (the workspace is the kernel's own), or the
    operations the chunked form needs at the rate of the unit that runs
    them. The products r~ S, k~^T v and A v run on the tensor cores in
    3xTF32: three TF32 products per f32 product, two where v is bf16 (exact
    in TF32). A's decayed products, its diagonal and the decay of S run on
    f32 FMAs."""
    f32 = torch.float32
    outs = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=c)
    r = args[0]
    B, S, H, K = r.shape
    V = args[2].shape[3]
    nbytes = (sum(x.numel() * x.element_size() for x in args)
              + sum(x.numel() * x.element_size() for x in outs))
    pairs = c * (c - 1) // 2
    per_v = 2 if args[2].dtype == torch.bfloat16 else 3
    n = B * H * (S // c)
    tensor = n * (2 * c * K * V * 3                     # r~ @ S
                  + (2 * c * K * V                      # k~^T v
                     + c * (c + 1) * V) * per_v)        # A @ v, lower triangle
    fma = n * (4 * pairs * K                            # decayed products of A
               + 3 * c * K + K * V)                     # diagonal, decay of S
    flops = n * (4 * c * K * V + c * (c + 1) * V) + fma
    t_ops = tensor / TF32_FLOPS_PER_S + fma / F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    fn = lambda: ops.rwkv6_chunk(*args, out_dtype=f32, chunk=c)  # noqa: E731
    return {"ms": cuda_time_ms(fn), "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "host_issue_ms": host_issue_ms(fn)}


def graph_vs_eager(label: str, fn, arrays, reset, card: str) -> None:
    """One step ``fn`` over int32 ``arrays`` captured as a CUDA graph
    (engine/graphs.py) beside the same step called eagerly, each from the
    state ``reset`` leaves: logs whether the logits are equal bit for bit,
    and else the largest difference."""
    dev = torch.device("cuda")
    reset()
    want = graphs.capture(fn, arrays, dev)[0](*arrays)[0]
    step, secs = graphs.capture(fn, arrays, dev,
                                pool=torch.cuda.graph_pool_handle(),
                                stream=torch.cuda.Stream())
    reset()
    got = step(*arrays)[0]
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    log(f"[graphs] {label}: graphed vs eager logits "
        + ("equal bit for bit" if torch.equal(got, want) else
           f"differ: largest difference {diff:.3e} of the largest |logit| "
           f"{top:.3e}") + f"; capture {secs:.3f}s; {card}")


def graph_logits_check(model, params, card: str) -> None:
    """A prefill and a decode step of the model as its serve's executor runs
    them (SERVE), graphed against eager on the same inputs: the paged
    backend's prefill + scatter of 4 ragged rows and a decode step over
    them, the dense backend's one-row prefill and a decode step over 4
    slots (its recurrent state reset before each)."""
    cfg = model.cfg
    dev = params["embed"].device
    backend = SERVE[cfg.name][0]
    L, bs = GRAPH_CHECK_LEN, 16
    rng = np.random.RandomState(SEED)
    lens = np.array([L - bs, 100, 77, 1], np.int32)
    toks = rng.randint(0, cfg.vocab_size - 2, size=(4, L)).astype(np.int32)
    nxt = rng.randint(0, cfg.vocab_size - 2, size=(4,)).astype(np.int32)
    if backend == "paged":
        m = model.with_prefill_attn("flash")
        nblk = L // bs
        pools = m.init_paged_pools(4 * nblk + 1, bs, dev)
        tables = np.arange(4 * nblk, dtype=np.int32).reshape(4, nblk)

        def prefill(t, sl, tb):
            lg, caches = m.prefill(params, t, seq_lens=sl, max_len=L)
            return lg, m.scatter_prefill_pools(pools, caches, tb)

        def decode(t, pos, tb, ctx):
            return m.decode_step_paged(params, pools, t, pos, tb, ctx,
                                       attn_impl="kernel")

        graph_vs_eager(f"{cfg.name} paged prefill [4, {L}]", prefill,
                       [toks, lens, tables], lambda: None, card)
        graph_vs_eager(f"{cfg.name} paged decode [4] over {nblk} blocks",
                       decode, [nxt, lens, tables, lens + 1], lambda: None,
                       card)
        del pools
    else:
        cache = model.init_cache(4, L, dev)

        def reset():
            for c in cache.values():
                c.zero_()

        def prefill(t, sl):
            return model.prefill(params, t, seq_lens=sl, max_len=L)

        def decode(t, pos):
            return model.decode_step(params, cache, t, pos)

        graph_vs_eager(f"{cfg.name} dense prefill [1, {L}]", prefill,
                       [toks[:1], lens[:1]], lambda: None, card)
        graph_vs_eager(f"{cfg.name} dense decode [4]", decode, [nxt, lens],
                       reset, card)
        del cache
    free()


def rwkv_graph_check(card: str) -> None:
    """rwkv6_chunk (its carry launched as the intra pass's programmatic
    dependent) captured in a CUDA graph: the replay's output and state equal
    the eager call's bit for bit, at one layer's call of the serve."""
    f32 = torch.float32
    args = rwkv_layer_inputs(torch.bfloat16)
    want = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.rwkv6_chunk(*args, out_dtype=f32, chunk=16)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = ops.rwkv6_chunk(*args, out_dtype=f32, chunk=16)
    for x in got:
        x.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[graphs] rwkv6_chunk r={list(args[0].shape)} c=16 replayed from a "
        f"CUDA graph vs eager: output and state "
        f"{'equal bit for bit' if same else 'differ'}; {card}")
    check(same, "a replayed rwkv6_chunk differs from the eager call")


def phase_graphs(model, params, loops=("serial",)) -> None:
    """CUDA graphs against eager steps (the executors' ``eager=True``) on
    the trace whose relQueries all arrive at once (GRAPH_TRACE), so both
    serve the same batches: the logits of one prefill and one decode step
    (graph_logits_check); in each of ``loops`` a graphed then an eager
    serve, whose streams must be identical and whose per-kernel launches
    must be equal (one per layer per prefill call or decode step); then a
    window of each, serial, profiled (phase_profile) after its executor
    captured the graphed serial serve's buckets (the steady state; capture
    seconds are the serves'). Each row goes to GRAPH_ROWS."""
    card = nvidia_smi_line()
    cfg = model.cfg
    backend = SERVE[cfg.name][0]
    trace = serve_trace(cfg.vocab_size - 2, **GRAPH_TRACE)
    graph_logits_check(model, params, card)
    if "rwkv6_chunk" in model.KERNELS:
        rwkv_graph_check(card)
    row = {"arch": cfg.name, "backend": backend}
    for loop in loops:
        runs = {}
        for mode in ("graphed", "eager"):
            ops.reset_launch_counts()
            run = run_serve(model, params, trace, loop, card=card,
                            eager=mode == "eager")
            run["launches"] = ops.launch_counts()
            check_serve_launches(cfg, run["launches"], run, f"{loop} {mode}")
            runs[mode] = run
        g, e = runs["graphed"], runs["eager"]
        check(g["streams"] == e["streams"],
              f"{cfg.name} {loop}: graphed and eager streams differ")
        check(g["launches"] == e["launches"],
              f"{cfg.name} {loop}: graphed launches {g['launches']}, eager "
              f"{e['launches']}")
        log(f"[graphs] {cfg.name} {backend} {loop}: streams identical "
            f"({len(g['streams'])} rows), launches equal {g['launches']} over "
            f"{g['prefills']} prefill calls and {g['steps']} decode steps; "
            f"graphed: {graphs_line(g)}; eager: peak max_memory_allocated "
            f"{gib(e['peak_bytes'])}; wall graphed {g['wall']:.3f}s, eager "
            f"{e['wall']:.3f}s; {card}")
        row[loop] = {mode: {k: r[k] for k in ("wall", "graphs", "capture_s",
                                               "prestage_s", "pool_bytes",
                                               "peak_bytes", "batches")}
                     for mode, r in runs.items()}
        if loop == "serial":
            row["warm"] = g
    # the windows show the steady state: each executor first captures the
    # buckets the graphed serial serve of the same batches captured
    row["profile"] = {mode: phase_profile(model, params, trace=trace,
                                          eager=mode == "eager",
                                          warm=row["warm"])
                      for mode in ("graphed", "eager")}
    del row["warm"]
    GRAPH_ROWS.append(row)


def log_graph_rows(card: str) -> None:
    """phase_graphs' rows, one line each and as one JSON object."""
    for r in GRAPH_ROWS:
        p = r["profile"]
        walls = "; ".join(
            f"{loop} wall {r[loop]['graphed']['wall']:.3f} / "
            f"{r[loop]['eager']['wall']:.3f}s"
            for loop in ("serial", "pipelined") if loop in r)
        s = r["serial"]["graphed"]
        log(f"[graphs] summary {r['arch']} {r['backend']} graphed / eager: "
            f"{walls}; idle {p['graphed']['idle']} / {p['eager']['idle']}; "
            f"host launches per batch {p['graphed']['host_per']} / "
            f"{p['eager']['host_per']}; device kernels per batch "
            f"{p['graphed']['kernels_per']} / {p['eager']['kernels_per']}; "
            f"{s['graphs']} graphs, capture {s['capture_s']:.2f}s, prestage "
            f"{s['prestage_s']:.2f}s, pool {gib(s['pool_bytes'])}, peak "
            f"{gib(s['peak_bytes'])} / "
            f"{gib(r['serial']['eager']['peak_bytes'])}; {card}")
    log("[graphs] json " + json.dumps({"card": card, "rows": GRAPH_ROWS}))


class WindowDone(Exception):
    """Raised by a profiled serve's dispatch once its window is traced: the
    rest of the serve is not needed."""


def precapture(ex, run: dict) -> None:
    """Capture before a serve starts every bucket that ``run``, a graphed
    serve of the same batches, captured as it went (eager steps for an
    eager executor)."""
    for key in run["buckets"]:
        if key not in ex._prefill_fn:
            args = key if isinstance(key, tuple) else (key,)
            ex._prefill_fn[key] = ex._prefill_step(*args)[0]
    for key in run["decode_keys"]:
        if key not in ex._decode_fn:
            ex._decode_fn[key] = ex._decode_step(*key)[0]
    if run.get("cow") and ex._copy_fn is None:
        ex._copy_fn = ex._copy_step()[0]


def phase_profile(model, params, device="cuda", planned: bool = False,
                  trace=None, eager: bool = False, warm=None) -> dict:
    """Where a serve's time goes: a serial serve of ``trace`` (the serve
    trace by default; the planned serve of phase 7 with ``planned``), CUDA
    graphs or eager steps, the batches of PROFILE_WINDOW traced under
    torch.profiler on the device only; the serve stops after the window.
    With ``warm`` (a graphed serve of the same batches) the executor
    captures that serve's buckets before it starts, so the window shows
    the steady state, replays only. Logs and returns the device's busy and
    idle share of the window's wall time, host launches and device kernels
    per batch, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    if planned:
        trace = serve_trace(model.cfg.vocab_size - 2, **PLANNED_TRACE)
        cap = planned_cap(trace)
    elif trace is None:
        trace = serve_trace(model.cfg.vocab_size - 2)
    prof = profile(activities=acts)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    first, n = PROFILE_WINDOW
    span = {}
    trace = copy.deepcopy(trace)
    if planned:
        engine = planned_engine(model, params, "serial", cap, device)
    else:
        engine = serve_engine(model, params, "serial", device, eager)
    ex = engine.executor
    if warm is not None:
        precapture(ex, warm)
    inner, seen = ex.dispatch, [0]

    def dispatch(batch, now):   # start and stop the trace at batch boundaries
        if seen[0] in (first, first + n):
            sync()
            if seen[0] == first:
                prof.start()
                span["t0"] = time.perf_counter()
                span["graphs"], span["capture_s"] = ex.num_graphs, ex.capture_s
            else:
                span["t1"] = time.perf_counter()
                prof.stop()
                raise WindowDone
        seen[0] += 1
        return inner(batch, now)

    ex.dispatch = dispatch
    try:
        if planned:
            tok = HashTokenizer(vocab_size=model.cfg.vocab_size - 2)
            planner = Planner("full", tokenizer=tok)
            PlanExecutor(Frontend(engine), planner).replay(
                planner.plan_trace(trace))
        else:
            engine.run_trace(trace)
    except WindowDone:
        pass
    check("t1" in span, f"the serve has fewer than {first + n + 1} batches")
    mode = "graphed" if ex.num_graphs else "eager"
    captured = (f" ({ex.num_graphs - span['graphs']} graphs captured in it, "
                f"{ex.capture_s - span['capture_s']:.3f}s)"
                if ex.num_graphs else "")
    if warm is not None:
        check(ex.num_graphs == span["graphs"],
              f"a warmed profile window captured "
              f"{ex.num_graphs - span['graphs']} graphs")
    del engine, ex, inner
    free()
    return log_device_profile(
        prof, span["t1"] - span["t0"],
        f"{model.cfg.name} {'planned ' if planned else ''}serial serve "
        f"{mode}{', buckets captured first' if warm else ''}, batches "
        f"{first}..{first + n - 1}{captured}", n, "batch")


def log_device_profile(prof, wall_s: float, what: str, n: int,
                       unit: str) -> dict:
    """The device's busy and idle share of ``wall_s``, device kernels and
    host launches per ``unit`` (``n`` of them in the window) and the kernels
    that take the time. Host launches are the CUDA runtime and driver calls
    that put work on a stream (HOST_LAUNCH_CALLS): a graph's replay is one.
    Returns the figures (None where the profiler recorded no device time)."""
    from torch.autograd import DeviceType

    t1 = time.perf_counter()
    events = prof.key_averages()
    kernels = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    host = {e.key: e.count for e in events if e.key in HOST_LAUNCH_CALLS}
    log(f"[profile] summing the trace took {time.perf_counter() - t1:.1f}s")
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("[profile] the profiler recorded no device time: not measured")
        return {"idle": None, "kernels_per": None, "host_per": None}
    wall_us = wall_s * 1e6
    launches = sum(e.count for e in kernels)
    n_host = sum(host.values())
    log(f"[profile] {what} under the profiler: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of wall, "
        f"idle {1 - busy_us / wall_us:.3f}), {launches} kernel launches, "
        f"{launches / n:.0f} per {unit}; host launches "
        + (f"{n_host}, {n_host / n:.0f} per {unit} ({host})" if host
           else "not measured (no runtime calls in the trace)"))
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
            # every profiled serve prefills in bf16 at head dim 64 or 128
            # (the wgmma kernel) and decodes in one launch per call
            check("flash_prefill" not in name or "wgmma" in name,
                  f"a profiled bf16 prefill ran {name}, not the wgmma kernel")
            check("paged_attention" not in name
                  or name.startswith("paged_attention_kernel<"),
                  f"a profiled decode ran {name} beside the split kernel")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle": 1 - busy_us / wall_us, "kernels_per": launches / n,
            "host_per": n_host / n if host else None}


def load_model(arch: str, dtype: str = "", layers: int = 0,
               by_layer: bool = False):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = full_model(arch, dtype, layers=layers,
                                    by_layer=by_layer)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {model.param_count() / 1e9:.3f}B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}; init "
        f"{'by layer' if by_layer else 'whole'} "
        f"{time.perf_counter() - t0:.2f}s, peak torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return cfg, model, params


def lap(label: str, t0: float) -> float:
    """Log the seconds since ``t0`` under ``label``; returns now."""
    now = time.perf_counter()
    log(f"[time] {label}: {now - t0:.1f}s")
    return now


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def path_granite(t: float) -> tuple:
    """granite-moe-3b-a800m at full width and depth (phases 11-13). Returns
    (the serve's launch counts, the time of the last lap)."""
    cfg, model, params = load_model("granite-moe-3b-a800m", dtype="float32")
    phase_model_paged(cfg, model, params, MOE_F32_REL_TOL, witness=True,
                      lens=FULL_ROWS)
    t = lap("granite model f32", t)
    del cfg, model, params
    free()
    cfg, model, params = load_model("granite-moe-3b-a800m")
    short = (cfg.replace(num_layers=MOE_BF16_LAYERS),
             *first_layers(model, params, MOE_BF16_LAYERS))
    phase_model_paged(*short, lens=FULL_ROWS)
    phase_model_truth(*short, MOE_TRUTH_REL_TOL, MODEL_REL_TOL)
    phase_model_truth(cfg, model, params, MOE_TRUTH_REL_TOL, MODEL_REL_TOL)
    t = lap("granite model bf16", t)
    counts = phase_serve(model, params)
    t = lap("granite serve", t)
    phase_graphs(model, params)
    t = lap("granite graphs", t)
    del cfg, model, params
    free()
    return counts, t


def path_qwen3_moe(t: float) -> tuple:
    """qwen3-moe-30b-a3b at full width (phase 14), cut to QWEN3_MOE_LAYERS
    layers: kernel vs plain in float32; in bf16 against the float32 model
    on the same weights, and kernel vs plain with routes replayed; then at
    all 48 layers in bf16, drawn by layer: kernel vs plain with routes
    replayed, the paged serve in both loops. Returns (the serve's launch
    counts, the time of the last lap)."""
    cfg, model, params = load_model("qwen3-moe-30b-a3b", dtype="float32",
                                    layers=QWEN3_MOE_LAYERS)
    phase_model_paged(cfg, model, params, MOE_F32_REL_TOL, witness=True,
                      lens=FULL_ROWS)
    del cfg, model, params
    free()
    cfg, model, params = load_model("qwen3-moe-30b-a3b",
                                    layers=QWEN3_MOE_LAYERS)
    phase_model_truth(cfg, model, params, MOE_TRUTH_REL_TOL, MODEL_REL_TOL)
    del cfg, model, params
    free()
    t = lap("qwen3-moe model", t)
    cfg, model, params = load_model("qwen3-moe-30b-a3b", by_layer=True)
    phase_model_truth(cfg, model, params, None, MODEL_REL_TOL,
                      with_truth=False)
    t = lap("qwen3-moe 48 layers model bf16", t)
    counts = phase_serve(model, params)
    t = lap("qwen3-moe serve", t)
    del cfg, model, params
    free()
    return counts, t


def path_large_dense(arch: str, t: float, graphs_too: bool) -> tuple:
    """qwen2.5-32b or the internvl2-26b backbone at full width (phases 14a,
    14b), drawn by layer: kernels vs plain in float32 at LARGE_F32_LAYERS
    layers (full rows, beside the PERTURB witness) and in bf16 at full
    depth; the paged serve in both loops; with ``graphs_too`` graphs against
    eager steps (phase_graphs). Returns (the serve's launch counts, the time
    of the last lap)."""
    cfg, model, params = load_model(arch, "float32", LARGE_F32_LAYERS,
                                    by_layer=True)
    phase_model_paged(cfg, model, params, MOE_F32_REL_TOL, witness=True,
                      lens=FULL_ROWS)
    del cfg, model, params
    free()
    t = lap(f"{arch} model f32", t)
    cfg, model, params = load_model(arch, by_layer=True)
    phase_model_paged(cfg, model, params)
    t = lap(f"{arch} model bf16", t)
    counts = phase_serve(model, params)
    t = lap(f"{arch} serve", t)
    if graphs_too:
        phase_graphs(model, params)
        t = lap(f"{arch} graphs", t)
    del cfg, model, params
    free()
    return counts, t


def path_gemma(t: float) -> float:
    """gemma3-12b at full width and depth on the dense engine (phase 15)."""
    cfg, model, params = load_model("gemma3-12b", dtype="float32",
                                    layers=GEMMA_F32_LAYERS)
    phase_model_window(cfg, model, params, GEMMA_F32_REL_TOL)
    del cfg, model, params
    free()
    t = lap("gemma3 model f32", t)
    cfg, model, params = load_model("gemma3-12b")
    phase_model_window(cfg, model, params, None)
    t = lap("gemma3 model bf16", t)
    phase_serve(model, params, loops=("serial",), trace_kw=GEMMA_TRACE)
    t = lap("gemma3 serve", t)
    del cfg, model, params
    free()
    return t


def path_hymba(t: float) -> tuple:
    """hymba-1.5b at full width on the dense engine (phases 16-18). Returns
    (the serve's launch counts, the time of the last lap)."""
    cfg, model, params = load_model("hymba-1.5b", dtype="float32",
                                    layers=HYMBA_F32_LAYERS)
    phase_model_window(cfg, model, params, HYMBA_F32_REL_TOL)
    del cfg, model, params
    free()
    t = lap("hymba model f32", t)
    cfg, model, params = load_model("hymba-1.5b")
    n = HYMBA_BF16_LAYERS
    phase_model_window(cfg.replace(num_layers=n),
                       *first_layers(model, params, n), MODEL_REL_TOL)
    phase_model_window(cfg, model, params, None)
    t = lap("hymba model bf16", t)
    counts = phase_serve(model, params, exact=True)
    t = lap("hymba serve", t)
    phase_graphs(model, params)
    t = lap("hymba graphs", t)
    del cfg, model, params
    free()
    return counts, t


def phase_model_whisper(cfg, model, params, tol, device="cuda") -> None:
    """Encoder over 1500 frames (rows of WHISPER_FRAME_LENS valid frames),
    a decoder prefill of WHISPER_PROMPT tokens, then WHISPER_DECODE_STEPS
    decode steps against the cross-attention cache, teacher-forced, each
    against the same position of one decoder pass over the whole extended
    prompt on the same encoder output; held to ``tol`` of the largest
    |logit| (None: reported only)."""
    B, n, steps = len(WHISPER_FRAME_LENS), WHISPER_PROMPT, WHISPER_DECODE_STEPS
    S = max(WHISPER_FRAME_LENS)
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, n + steps)),
                           dtype=torch.int32, device=device)
    frames = torch.as_tensor(rng.randn(B, S, cfg.d_model).astype(np.float32),
                             device=device)
    fl = torch.as_tensor(WHISPER_FRAME_LENS, dtype=torch.int32, device=device)
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :n], frames=frames, seq_lens=fl)
        check(tuple(cache["k_cross"].shape[:3]) == (cfg.num_layers, B, S)
              and cache["k_self"].shape[2] == cfg.max_target_len,
              "whisper cache layout")
        got = []
        for j in range(steps):
            pos = torch.full((B,), n + j, dtype=torch.int32, device=device)
            d, cache = model.decode_step(params, cache, toks[:, n + j], pos)
            got.append(d)
        enc = model.encode(params, frames, fl)
        hidden, _ = model._decode_tokens(params, toks, enc, fl)
        want = [model.logits(params, hidden[:, n + j]) for j in range(steps)]
    what = (f"{cfg.name} {cfg.num_encoder_layers}+{cfg.num_layers} layers "
            f"{cfg.dtype}: {S} frames (valid {list(WHISPER_FRAME_LENS)}), "
            f"prompt {n}, decode steps vs one decoder pass")
    worst = max(log_rel("whisper model", f"{what}, step {j}", got[j], want[j],
                        tol) for j in range(steps))
    log(f"[whisper model] {what}: worst rel {worst:.3e}")


def path_whisper(t: float) -> tuple:
    """whisper-base at full width and depth (phase 19): float32 held,
    bf16 reported. Returns (its launch counts, the time of the last lap)."""
    ops.reset_launch_counts()
    for dtype, tol in (("float32", WHISPER_F32_REL_TOL), ("", None)):
        cfg, model, params = load_model("whisper-base", dtype=dtype)
        phase_model_whisper(cfg, model, params, tol)
        del cfg, model, params
        free()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"whisper launched a kernel: {counts}")
    return counts, lap("whisper model", t)


def sync_seconds(fn):
    """(fn(), its seconds between two device synchronisations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_leaves(paths, leaves, by_path) -> bool:
    """``leaves`` (at ``paths``) and ``by_path`` ({path: tensor}, possibly
    on the host): the same paths, dtypes and bits."""
    return list(by_path) == paths and all(
        x.dtype == by_path[p].dtype and torch.equal(x, by_path[p].to(x.device))
        for p, x in zip(paths, leaves))


def run_train(step, batch, n_steps: int, window, what: str) -> tuple:
    """``n_steps`` calls of the train step ``step`` on the host ``batch``,
    each timed between two device synchronisations, steps ``window``
    (first, count) traced on the device. Returns (losses, seconds, the last
    metrics, log_device_profile's figures)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    first, n = window
    losses, secs = [], []
    for i in range(n_steps):
        if i == first:
            prof.start()
        m, dt = sync_seconds(lambda: step(batch))
        if i == first + n - 1:
            prof.stop()
        losses.append(float(m["loss"]))
        secs.append(dt)
    fig = log_device_profile(prof, sum(secs[first:first + n]), what, n, "step")
    return losses, secs, m, fig


def per(x, n):
    """``x / n``, None where ``x`` was not measured."""
    return None if x is None else x / n


def host_trees(trees):
    """``trees`` copied to the host."""
    return tree_map(lambda x: x.cpu(), trees)


def same_trees(live, host) -> bool:
    """Two trees of the same paths, dtypes and bits (``host`` anywhere)."""
    return same_leaves(*tree_flatten(live), dict(zip(*tree_flatten(host))))


def phase_train(device="cuda") -> dict:
    """qwen3-1.7b at full width and depth through the captured train step
    (``TrainStep``: the first call a real step run eagerly, then one CUDA
    graph replayed): TRAIN_STEPS steps on one batch of the reference CLI's
    token stream; every loss finite and the last below TRAIN_LOSS_DROP of
    the first; no kernel of this repo launched; steps TRAIN_PROFILE traced
    on the device. Then the eager in-place step on the same trees for
    comparison (TRAIN_EAGER_STEPS, steps TRAIN_EAGER_PROFILE traced): step
    time, host launches per step, idle share, capture seconds, graph pool
    and peak memory side by side. Under deterministic algorithms (the
    backward of the embedding gather and of the loss's gather would
    otherwise add with atomics in any order), TRAIN_CHECK_STEPS replays of
    a step captured under them against as many eager steps from the same
    state: losses, grad norms and every leaf bit for bit. Then a
    checkpoint: written, read back bit for bit, and a step after
    ``load_state`` of it equal to a step from the live state. Returns the
    launch counts."""
    cfg, model, params = load_model("qwen3-1.7b")
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    ds = make_dataset("rotten", num_rows=2000, seed=SEED)
    batch = next(token_stream(ds, tok, TRAIN_BATCH, TRAIN_SEQ, SEED))
    card = nvidia_smi_line()
    tc = TrainConfig(adamw=AdamWConfig(lr=TRAIN_LR))
    opt = init_opt_state(params)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step = TrainStep(model, tc, params, opt)
    first, n = TRAIN_PROFILE
    losses, secs, m, cap = run_train(
        step, batch, TRAIN_STEPS, TRAIN_PROFILE,
        f"{cfg.name} captured train steps {first}..{first + n - 1}")
    peak, pool = torch.cuda.max_memory_allocated(), graphs.pool_bytes(step.pool)
    counts = ops.launch_counts()
    plain = secs[1:first] + secs[first + n:]
    log(f"[train] {cfg.name} {cfg.num_layers} layers bf16 params, f32 masters "
        f"({model.param_count() / 1e9:.3f}B params), batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, lr {TRAIN_LR:g}, remat on, captured: losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"[train] captured step time: first (a real step run eagerly, then "
        f"the capture) {secs[0] * 1e3:.1f} ms, of it the capture "
        f"{step.capture_s * 1e3:.1f} ms; median of the unprofiled replays "
        f"{float(np.median(plain)) * 1e3:.1f} ms, min {min(plain) * 1e3:.1f} "
        f"ms; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; graph "
        f"pool {gib(pool)}; grad norm last {float(m['grad_norm']):.4f}; "
        f"launches {counts}; {card}")
    check(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    check(losses[-1] < TRAIN_LOSS_DROP * losses[0],
          f"no learning: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(not any(counts.values()), f"training launched a kernel: {counts}")
    capture_s = step.capture_s
    del step
    free()

    torch.cuda.reset_peak_memory_stats()
    eager = TrainStep(model, tc, params, opt, eager=True)
    first, n = TRAIN_EAGER_PROFILE
    _, e_secs, _, eag = run_train(
        eager, batch, TRAIN_EAGER_STEPS, TRAIN_EAGER_PROFILE,
        f"{cfg.name} eager train steps {first}..{first + n - 1}")
    e_peak = torch.cuda.max_memory_allocated()
    e_plain = e_secs[1:first] + e_secs[first + n:]
    del eager
    free()
    row = {"step_ms": float(np.median(plain)) * 1e3,
           "eager_step_ms": float(np.median(e_plain)) * 1e3,
           "host_per_step": cap["host_per"], "eager_host_per_step": eag["host_per"],
           "idle": cap["idle"], "eager_idle": eag["idle"],
           "busy_ms_per_step": per(cap.get("busy_ms"), TRAIN_PROFILE[1]),
           "eager_busy_ms_per_step": per(eag.get("busy_ms"),
                                         TRAIN_EAGER_PROFILE[1]),
           "capture_s": capture_s, "pool_bytes": pool, "peak_bytes": peak,
           "eager_peak_bytes": e_peak, "card": card}
    log(f"[train] captured vs eager ({cfg.name}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}): step median {row['step_ms']:.1f} vs "
        f"{row['eager_step_ms']:.1f} ms; host launches per step "
        f"{row['host_per_step']} vs {row['eager_host_per_step']}; idle "
        f"{row['idle']} vs {row['eager_idle']}; device busy per step "
        f"{row['busy_ms_per_step']} vs {row['eager_busy_ms_per_step']} ms; "
        f"capture {capture_s:.2f}s; graph pool {gib(pool)}; peak "
        f"{peak / 2**30:.2f} vs {e_peak / 2**30:.2f} GiB; {card}")
    log("[train] json " + json.dumps(row))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        start = host_trees({"params": params, "opt": opt})
        eager = TrainStep(model, tc, params, opt, eager=True)
        want = [eager(batch) for _ in range(TRAIN_CHECK_STEPS)]
        want = [(float(x["loss"]), float(x["grad_norm"])) for x in want]
        after = host_trees(eager.trees)
        del eager
        step = TrainStep(model, tc, params, opt)
        step(batch)                         # the warm-up and the capture
        step.load_state(start)
        got = [step(batch) for _ in range(TRAIN_CHECK_STEPS)]
        got = [(float(x["loss"]), float(x["grad_norm"])) for x in got]
        same = same_trees(step.trees, after)
        del start, after
        log(f"[train] {TRAIN_CHECK_STEPS} captured steps vs as many eager ones "
            f"from the same state (deterministic algorithms): (loss, grad "
            f"norm) {got} vs {want}; params, m, v, master and step equal bit "
            f"for bit: {same}")
        check(got == want and same, "the captured train step differs from "
                                    "the eager one")

        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        _, dt = sync_seconds(lambda: save_checkpoint(
            CKPT_DIR, TRAIN_STEPS, step.trees, {"arch": cfg.name}))
        skeleton = tree_map(lambda x: x.new_empty(0, device="cpu"), step.trees)
        (at, host), dt_read = sync_seconds(
            lambda: load_checkpoint(CKPT_DIR, template_trees=skeleton))
        check(at == TRAIN_STEPS, f"the checkpoint reads back as step {at}")
        for name, tree in step.trees.items():
            check(same_trees(tree, host[name]),
                  f"checkpoint {name} did not read back bit for bit")
        nbytes = sum(x.numel() * x.element_size()
                     for x in tree_flatten(step.trees)[1])
        m_live = step(batch)
        p_live = tree_map(torch.clone, step.params)
        step.load_state(host)
        del host
        m_back = step(batch)
        same = same_trees(step.params, p_live)
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] checkpoint at step {TRAIN_STEPS}: {nbytes / 2**30:.2f} GiB "
        f"written in {dt:.1f}s, read back bit for bit in {dt_read:.1f}s; the "
        f"captured step after load_state of it vs from the live state "
        f"(deterministic algorithms): loss {float(m_back['loss']):.6f} vs "
        f"{float(m_live['loss']):.6f}, params equal: {same}")
    check(float(m_back["loss"]) == float(m_live["loss"]) and same,
          "a run resumed from the checkpoint differs from the unbroken one")
    shutil.rmtree(CKPT_DIR)
    del step, p_live, params, opt
    free()
    return counts


def family_batch(cfg, device="cuda") -> dict:
    """TRAIN_BATCH x TRAIN_SEQ random tokens and labels (for whisper at
    most max_target_len of them, beside 1500 frames with ragged
    frame_lens)."""
    rng = np.random.RandomState(SEED)
    seq = min(TRAIN_SEQ, cfg.max_target_len or TRAIN_SEQ)
    batch = {k: torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                            size=(TRAIN_BATCH, seq)),
                                dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    if cfg.is_encoder_decoder:
        S = max(WHISPER_FRAME_LENS)
        batch["frames"] = torch.as_tensor(
            rng.randn(TRAIN_BATCH, S, cfg.d_model).astype(np.float32),
            device=device)
        batch["frame_lens"] = torch.as_tensor(
            rng.randint(S // 2, S + 1, size=TRAIN_BATCH), dtype=torch.int32,
            device=device)
    return batch


def reset_train_state(step, p0) -> None:
    """A train step's live trees set back, in place, to ``p0`` and
    ``init_opt_state(p0)``'s state (zero moments and step, the masters
    ``p0`` in float32)."""
    leaves = lambda t: tree_flatten(t)[1]  # noqa: E731
    with torch.no_grad():
        for p, w, x in zip(leaves(step.params), leaves(step.opt["master"]),
                           leaves(p0)):
            p.copy_(x)
            w.copy_(x)
        for t in leaves(step.opt["m"]) + leaves(step.opt["v"]):
            t.zero_()
        step.opt["step"].zero_()


def phase_train_families(device="cuda") -> dict:
    """One train step (bf16, remat) of each family at full width cut to
    TRAIN_FAMILY_LAYERS layers, under deterministic algorithms: the eager
    in-place step, with the CUDA runtime set to raise on a synchronising
    call (a step that syncs the host cannot be captured), and one replay of
    the captured step from the same state (``TrainStep``; its first call,
    the warm-up, a real step, is undone by ``reset_train_state``): loss and
    grad norm finite, losses, grad norms and the new parameters equal bit
    for bit (every leaf of the state: tests/test_torch_gpu.py); no kernel
    of this repo launched. Returns the launch counts over all of them."""
    ops.reset_launch_counts()
    tc = TrainConfig(adamw=AdamWConfig(lr=TRAIN_LR))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch in TRAIN_FAMILIES:
            n = TRAIN_FAMILY_LAYERS
            cfg = get_config(arch).replace(num_layers=n)
            if cfg.is_encoder_decoder:
                cfg = cfg.replace(num_encoder_layers=n)
            model = build_model(cfg)
            params = model.init_params(
                torch.Generator(device=device).manual_seed(SEED))
            p0 = tree_map(torch.clone, params)
            batch = {k: v.cpu() for k, v in family_batch(cfg, device).items()}
            eager = TrainStep(model, tc, params, init_opt_state(params),
                              eager=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                m_e = eager(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            dt_e = time.perf_counter() - t0
            want_params = tree_map(torch.clone, params)
            step = TrainStep(model, tc, params, eager.opt)
            del eager
            _, dt_first = sync_seconds(lambda: step(batch))
            reset_train_state(step, p0)
            m_c, dt_c = sync_seconds(lambda: step(batch))
            got = (float(m_c["loss"]), float(m_c["grad_norm"]))
            want = (float(m_e["loss"]), float(m_e["grad_norm"]))
            same = same_trees(step.params, want_params)
            log(f"[train family] {cfg.name} ({cfg.family}) {n} layers, "
                f"{model.param_count() / 1e9:.3f}B params: loss {got[0]:.4f}, "
                f"grad norm {got[1]:.4f}; eager step {dt_e * 1e3:.1f} ms "
                f"(no synchronising call), first captured call (a real step, "
                f"then the capture) {dt_first * 1e3:.1f} ms, of it the "
                f"capture {step.capture_s * 1e3:.1f} ms, a replay "
                f"{dt_c * 1e3:.1f} ms; graph pool {gib(graphs.pool_bytes(step.pool))}; "
                f"captured vs eager (deterministic algorithms): (loss, grad "
                f"norm) {got} vs {want}, new params equal bit for bit: {same}")
            check(all(map(math.isfinite, got)),
                  f"{cfg.name}: non-finite loss or gradient")
            check(got == want and same,
                  f"{cfg.name}: the captured train step differs from the eager one")
            del model, params, p0, want_params, batch, step
            free()
    finally:
        torch.use_deterministic_algorithms(False)
    counts = ops.launch_counts()
    check(not any(counts.values()), f"a family's train step launched a "
                                    f"kernel: {counts}")
    return counts


def md_prompts(cfg, device="cuda"):
    """Four prompts of up to 128 tokens (rows of 120, 97, 64 and 33) and
    MD_DECODE_STEPS teacher-forced decode tokens per row."""
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(4, 128)),
                           dtype=torch.int32, device=device)
    lens = torch.as_tensor((120, 97, 64, 33), dtype=torch.int32, device=device)
    nxt = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                      size=(MD_DECODE_STEPS, 4)),
                          dtype=torch.int32, device=device)
    return toks, lens, nxt


@contextlib.contextmanager
def count_collectives():
    """Count the calls of the collectives the port issues (all_reduce,
    all_gather_into_tensor) while inside; yields the counts."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather_into_tensor": 0}
    inner = {k: getattr(dist, k) for k in counts}

    def wrap(name):
        def fn(*a, **kw):
            counts[name] += 1
            return inner[name](*a, **kw)
        return fn
    for k in counts:
        setattr(dist, k, wrap(k))
    try:
        yield counts
    finally:
        for k, f in inner.items():
            setattr(dist, k, f)


def md_seq_parallel(mesh, pc, dtype: str, layers: int, tol, timed: bool,
                    device="cuda") -> None:
    """qwen3-1.7b: a prefill of md_prompts on DenseTransformer(cfg, pc) with
    the flash_prefill kernel, its cache resharded to the sequence-parallel
    layout, then MD_DECODE_STEPS sequence-parallel decode steps on the mesh
    against the single-device decode_step from the same cache; held to
    ``tol``. With ``timed``: the two steps' times and the collectives of one
    sequence-parallel step (calls, and NCCL kernels in a device trace)."""
    from torch.profiler import ProfilerActivity, profile

    cfg, _, params = full_model("qwen3-1.7b", dtype, device, layers)
    base = DenseTransformer(cfg, pc).with_prefill_attn("flash")
    sp = SeqParallelDenseTransformer(cfg, pc, mesh)
    sparams = shard_params(params_from_packed(params, base), sp.templates(), pc,
                           mesh)
    toks, lens, nxt = md_prompts(cfg, device)
    max_len = toks.shape[1] + MD_DECODE_STEPS
    with torch.no_grad():
        _, cache = base.prefill(params, toks, seq_lens=lens, max_len=max_len)
        scache = reshard_cache_from_packed(cache, base, sp)
        check(all(x.to_local().device.type == device for x in scache.values()),
              "the sequence-parallel cache is not on the card")
        what = f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}"
        for j in range(MD_DECODE_STEPS):
            want, cache = base.decode_step(params, cache, nxt[j], lens + j)
            got, scache = sp.decode_step(sparams, scache, nxt[j], lens + j)
            log_rel("multi-device", f"{what}: sequence-parallel decode step {j} "
                    f"on the (1, 1) mesh vs decode_step", got.full_tensor(),
                    want, tol)
        if not timed:
            return
        at = lens + MD_DECODE_STEPS - 1
        plain_s, sp_s = [], []
        for i in range(MD_TIMED_STEPS):    # in turns: plain, sp, sp, plain
            order = ("plain", "sp") if i % 2 == 0 else ("sp", "plain")
            for who in order:
                if who == "plain":
                    _, dt = sync_seconds(lambda: base.decode_step(
                        params, cache, nxt[-1], at))
                    plain_s.append(dt)
                else:
                    _, dt = sync_seconds(lambda: sp.decode_step(
                        sparams, scache, nxt[-1], at))
                    sp_s.append(dt)
        with count_collectives() as calls:
            sp.decode_step(sparams, scache, nxt[-1], at)
        with profile(activities=[ProfilerActivity.CUDA] if device == "cuda"
                     else [ProfilerActivity.CPU]) as prof:
            sp.decode_step(sparams, scache, nxt[-1], at)
            torch.cuda.synchronize()
    nccl = sum(e.count for e in prof.key_averages() if "nccl" in e.key.lower())
    L = cfg.num_layers
    log(f"[multi-device] {what}, batch 4: decode step, median of "
        f"{MD_TIMED_STEPS} (in turns): sequence-parallel on the (1, 1) NCCL "
        f"mesh {float(np.median(sp_s)) * 1e3:.2f} ms (min "
        f"{min(sp_s) * 1e3:.2f}), single-device decode_step "
        f"{float(np.median(plain_s)) * 1e3:.2f} ms (min "
        f"{min(plain_s) * 1e3:.2f}); collectives per step {calls} "
        f"({sum(calls.values())} = 5 x {L} layers + 2; "
        f"{sum(calls.values()) / L:.2f} per layer), NCCL kernels in a device "
        f"trace of one step {nccl}; {nvidia_smi_line()}")
    check(calls == {"all_reduce": 5 * L + 1, "all_gather_into_tensor": 1},
          f"collectives per step: {calls}")


def md_local_ep(mesh, pc, device="cuda") -> None:
    """granite-moe-3b-a800m at full width: prefill and one decode step of
    md_prompts with model.mesh set (moe_dispatch_local_ep; the experts placed
    on the model axis, the rest replicated) and unset (moe_dispatch), in
    float32 at MD_MOE_F32_LAYERS layers and in bf16 at full depth, the
    local-EP run replaying the moe_dispatch run's routes (and, reported, on
    its own routes)."""
    for dtype, layers, tol in (("float32", MD_MOE_F32_LAYERS, MOE_F32_REL_TOL),
                               ("", 0, MODEL_REL_TOL)):
        cfg, _, params = full_model("granite-moe-3b-a800m", dtype, device, layers)
        plain, ep = build_model(cfg, pc), build_model(cfg, pc)
        ep.mesh = mesh
        lp = local_tree(place_tree(params, mesh, ep.ep_param_specs()))
        toks, lens, nxt = md_prompts(cfg, device)
        routes = Routes()
        runs = {}
        with torch.no_grad():
            for name, m, p, route in (
                    ("moe_dispatch", plain, params, routes.record),
                    ("local EP, replayed", ep, lp, routes.replay),
                    ("local EP", ep, lp, contextlib.nullcontext)):
                with route():
                    lg, c = m.prefill(p, toks, seq_lens=lens, max_len=136)
                    d, _ = m.decode_step(p, c, nxt[0], lens)
                runs[name] = (lg, d)
        what = f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}"
        for i, step in enumerate(("prefill", "decode")):
            want = runs["moe_dispatch"][i]
            log_rel("multi-device", f"{what} {step}: local EP on the (1, 1) "
                    f"mesh replaying moe_dispatch's routes vs moe_dispatch",
                    runs["local EP, replayed"][i], want, tol)
            log_rel("multi-device", f"{what} {step}: local EP, own routes, vs "
                    f"moe_dispatch", runs["local EP"][i], want, None)
        del cfg, plain, ep, params, lp, runs
        free()


def md_zero1_elastic(mesh, pc, device="cuda") -> None:
    """qwen3-1.7b at full width cut to TRAIN_FAMILY_LAYERS layers, bf16:
    one AdamW step (real gradients of one batch) on DTensor state placed by
    opt_state_specs against the plain step, which at dp = 1 should agree bit
    for bit (reported, and held at 1e-6 of the largest value); then
    reshard_tree of the params and elastic_restore from a checkpoint written
    by fault_tolerance: the same bits."""
    cfg, _, params = full_model("qwen3-1.7b", "", device, TRAIN_FAMILY_LAYERS)
    model = DenseTransformer(cfg, pc)
    batch = family_batch(cfg, device)
    _, grads = loss_and_grads(model, params, batch, True)
    acfg = AdamWConfig(lr=TRAIN_LR)
    pspecs = model.param_specs()
    p1, s1, m1 = adamw_update(params, grads, init_opt_state(params), acfg)
    z_state = shard_opt_state(init_opt_state(params), pspecs, params, pc, mesh)
    q1, t1, n1 = adamw_update(shard_params(params, model.templates(), pc, mesh),
                              place_tree(grads, mesh, pspecs), z_state, acfg)
    worst, equal = 0.0, True
    for name, got, want in (("params", q1, p1), ("m", t1["m"], s1["m"]),
                            ("v", t1["v"], s1["v"]),
                            ("master", t1["master"], s1["master"])):
        for a, b in zip(tree_flatten(got)[1], tree_flatten(want)[1]):
            a = a.full_tensor()
            equal &= bool(torch.equal(a, b))
            worst = max(worst, float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp(min=1e-30)))
    log(f"[multi-device] ZeRO-1 AdamW step, {cfg.name} {cfg.num_layers} layers "
        f"bf16 params ({model.param_count() / 1e9:.3f}B), state placed by "
        f"opt_state_specs on the (1, 1) mesh vs the plain step: bit for bit "
        f"{equal}, worst rel {worst:.3e}; grad norm {float(n1['grad_norm']):.6f} "
        f"vs {float(m1['grad_norm']):.6f}")
    check(worst <= 1e-6 and float(n1["grad_norm"]) == float(m1["grad_norm"]),
          "the ZeRO-1 step differs from the plain step")
    del p1, s1, q1, t1, z_state, grads

    placed = reshard_tree(params, mesh, pspecs)
    shutil.rmtree(MD_CKPT_DIR, ignore_errors=True)
    save_checkpoint(MD_CKPT_DIR, 0, {"params": params})
    skeleton = {"params": tree_map(lambda x: x.new_empty(0), params)}
    _, trees = load_checkpoint(MD_CKPT_DIR, template_trees=skeleton)
    shutil.rmtree(MD_CKPT_DIR)
    _, restored = elastic_restore(build_model, cfg, mesh, trees)
    paths, want = tree_flatten(params)
    for label, tree in (("reshard_tree", placed),
                        ("elastic_restore", restored["params"])):
        same = same_leaves(paths, [x.full_tensor() for x in tree_flatten(tree)[1]],
                           dict(zip(paths, want)))
        log(f"[multi-device] {label} of the params onto the (1, 1) mesh: the "
            f"same bits {same}")
        check(same, f"{label} changed the parameters")


def phase_multi_device(device="cuda") -> dict:
    """Phase 22: the multi-device modules on a one-rank NCCL process group
    (a file store under a temporary directory) and a (1, 1) ("data",
    "model") DeviceMesh. Returns the path's launch counts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1, device_id=(torch.device("cuda", torch.cuda.current_device())
                                     if device == "cuda" else None))
        try:
            mesh = init_device_mesh(device, (1, 1),
                                    mesh_dim_names=("data", "model"))
            pc = ParallelConfig.from_mesh(mesh)
            log(f"[multi-device] mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, "
                f"backend {dist.get_backend(mesh.get_group('model'))}, {pc}")
            ops.reset_launch_counts()
            md_seq_parallel(mesh, pc, "float32", MD_F32_LAYERS, MD_F32_REL_TOL,
                            False, device)
            free()
            md_seq_parallel(mesh, pc, "", 0, MODEL_REL_TOL, True, device)
            free()
            md_local_ep(mesh, pc, device)
            md_zero1_elastic(mesh, pc, device)
            counts = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    free()
    n_prefill = MD_F32_LAYERS + get_config("qwen3-1.7b").num_layers
    log(f"[multi-device] launches {counts}")
    check(counts == {"paged_attention": 0, "flash_prefill": n_prefill,
                     "rwkv6_chunk": 0},
          f"multi-device launches {counts}: one flash_prefill per layer per "
          f"qwen3 prefill expected ({n_prefill})")
    return counts


# ----------------------------------------------------------------------------
# phase 23: the tensor-parallel forward, qwen3-1.7b's cells, the dry run
# ----------------------------------------------------------------------------
LEAF_PIECE = 1 << 26    # elements per piece of leaf_rel's float32 copies


def leaf_rel(got, want) -> float:
    """Worst leaf of two gradient trees: max |got - want| over the leaf's
    largest |want|, LEAF_PIECE elements at a time (a full-depth leaf's
    float32 copy alone is GiBs beside two gradient trees)."""
    worst = 0.0
    for a, b in zip(tree_flatten(got)[1], tree_flatten(want)[1]):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        pairs = list(zip(a.reshape(-1).split(LEAF_PIECE),
                         b.reshape(-1).split(LEAF_PIECE)))
        scale = max(float(y.float().abs().max()) for _, y in pairs)
        err = max(max_err(x, y) for x, y in pairs)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def tp_steps(m, p, cfg, toks, lens, nxt, frames):
    """TP_PREFILLS prefills of md_prompts' rows (whisper: WHISPER_PROMPT
    tokens of them over ``frames``, ``lens`` the valid frames), the last
    timed, and one decode step after it -> (prefill logits, decode logits,
    the timed prefill's seconds)."""
    def prefill():
        if cfg.is_encoder_decoder:
            return m.prefill(p, toks[:, :WHISPER_PROMPT], frames=frames,
                             seq_lens=lens)
        return m.prefill(p, toks, seq_lens=lens, max_len=136)

    with torch.no_grad():
        for _ in range(TP_PREFILLS - 1):
            prefill()
        (lg, cache), secs = sync_seconds(prefill)
        pos = (torch.full_like(lens, WHISPER_PROMPT) if cfg.is_encoder_decoder
               else lens)
        dec, _ = m.decode_step(p, cache, nxt[0], pos)
    return lg, dec, secs


def tp_forward_check(arch: str, dtype: str, layers: int, mesh, pc, tol,
                     grad_tol, device="cuda") -> None:
    """``arch`` at full width (``layers`` layers if given, in ``dtype``):
    the TP forward (DTensor weights placed by param_specs on the (1, 1)
    mesh; flash_prefill on the rank's heads in the dense and MoE families,
    rwkv6_chunk on its WKV heads) against the single-device model on the
    same weights: prefill and decode logits of md_prompts (whisper: over
    1500 frames), the train loss and gradients of family_batch (``grad_tol``
    None: reported only; remat at full depth, where rwkv6-7b's activations
    without it overflowed the card beside its weights). An MoE model's TP
    run replays the single-device run's routes."""
    t0 = time.perf_counter()
    cfg, single, params = full_model(arch, dtype, device, layers)
    tp = build_model(cfg, pc)
    if "flash_prefill" in single.KERNELS:
        single, tp = single.with_prefill_attn("flash"), tp.with_prefill_attn("flash")
    tp.mesh = mesh
    dparams = shard_params(params, tp.templates(), pc, mesh)
    toks, lens, nxt = md_prompts(cfg, device)
    frames = None
    if cfg.is_encoder_decoder:
        S = max(WHISPER_FRAME_LENS)
        frames = torch.as_tensor(np.random.RandomState(SEED).randn(
            4, S, cfg.d_model).astype(np.float32), device=device)
        lens = torch.as_tensor(WHISPER_FRAME_LENS * 2, dtype=torch.int32,
                               device=device)
    batch = family_batch(cfg, device)
    routes = Routes()
    moe_model = cfg.family == "moe"
    runs = {}
    for name, m, p, route in (
            ("single", single, params,
             routes.record if moe_model else contextlib.nullcontext),
            ("tp", tp, dparams,
             routes.replay if moe_model else contextlib.nullcontext)):
        with route():
            lg, dec, secs = tp_steps(m, p, cfg, toks, lens, nxt, frames)
            loss, grads = loss_and_grads(m, p, batch, not layers)
        full = (lambda x: x.full_tensor()) if name == "tp" else (lambda x: x)
        runs[name] = (full(lg), full(dec), loss, grads, secs)
    what = f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}" + (
        ", routes replayed" if moe_model else "")
    for i, step in enumerate(("prefill", "decode")):
        log_rel("tp forward", f"{what} {step}: the TP forward on the (1, 1) "
                f"mesh vs one device", runs["tp"][i], runs["single"][i], tol)
    l_t, l_s = float(runs["tp"][2]), float(runs["single"][2])
    g_rel = leaf_rel(runs["tp"][3], runs["single"][3])
    log(f"[tp forward] {what} train loss: TP {l_t:.7f} vs one device "
        f"{l_s:.7f} (rel {abs(l_t - l_s) / abs(l_s):.3e}, tol {tol:g}); "
        f"gradients' worst leaf rel {g_rel:.3e} (tol "
        f"{'reported only' if grad_tol is None else f'{grad_tol:g}'})")
    check(math.isfinite(l_t) and abs(l_t - l_s) <= tol * abs(l_s),
          f"{what}: the TP loss differs from one device's")
    check(grad_tol is None or g_rel <= grad_tol,
          f"{what}: the TP gradients differ")
    t_t, t_s = runs["tp"][4], runs["single"][4]
    log(f"[tp forward] {what} prefill wall (host clock, synchronised; each "
        f"run's prefill {TP_PREFILLS}): TP {t_t * 1e3:.2f} ms vs one device {t_s * 1e3:.2f} "
        f"ms ({t_t / t_s:.3f}x); {nvidia_smi_line()}; the check took "
        f"{time.perf_counter() - t0:.1f}s")


def tp_train_check(arch: str, layers: int, mesh, layout: str, compress: bool,
                   device="cuda") -> None:
    """One train step of ``arch``'s train_4k cell (bf16 parameters, float32
    masters) at full width cut to ``layers`` layers, batch family_batch,
    with ``train_layout`` ``layout`` and ``compress_grads`` ``compress``:
    on the (1, 1) mesh (parameters and state placed by the cell's
    in_shardings) against the same cell's step on one device, from the same
    weights. New parameters, m, v (and err) to TP_GRAD_REL_TOL of each
    leaf's largest; whether they are bit for bit equal is reported (on one
    rank every gather and reduce-scatter is the identity)."""
    cfg = get_config(arch).replace(num_layers=layers)
    shape = ShapeConfig("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    kw = dict(cfg_override=cfg, shape=shape, train_layout=layout,
              compress_grads=compress)
    one = build_cell(arch, "train_4k", None, **kw)
    cell = build_cell(arch, "train_4k", mesh, **kw)
    params = one.model.init_params(torch.Generator(device=device).manual_seed(SEED))
    batch = family_batch(cfg, device)
    specs = cell.in_shardings[0]
    p_s, o_s, m_s = one.fn(params, init_opt_state(params), batch)
    p_t, o_t, m_t = cell.fn(place_tree(params, mesh, specs),
                            shard_opt_state(init_opt_state(params), specs,
                                            params, cell.pc, mesh), batch)
    trees = [("params", p_t, p_s), ("m", o_t["m"], o_s["m"]),
             ("v", o_t["v"], o_s["v"])]
    if compress:
        trees.append(("err", o_t["err"], o_s["err"]))
    rels, same = {}, True
    for name, got, want in trees:
        rels[name] = leaf_rel(got, want)
        same &= all(torch.equal(a.full_tensor(), b) for a, b in
                    zip(tree_flatten(got)[1], tree_flatten(want)[1]))
    loss_t, loss_s = float(m_t["loss"]), float(m_s["loss"])
    ga = TRAIN_GRAD_ACCUM.get(arch, 1) if layout == "tp" else 1
    what = (f"{cfg.name} {layers} layers, train_layout {layout}, "
            f"compress_grads {compress}, grad_accum {ga}")
    log(f"[tp train] {what}: one step on the (1, 1) mesh vs one device: loss "
        f"{loss_t:.7f} vs {loss_s:.7f}; worst leaf rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
        + f"; bit for bit: {same}")
    check(math.isfinite(loss_t)
          and abs(loss_t - loss_s) <= TP_F32_REL_TOL * abs(loss_s), f"{what}: loss")
    check(max(rels.values()) <= TP_GRAD_REL_TOL, f"{what}: the step differs")


def phase_tp_forward(device="cuda") -> dict:
    """The whole-model TP forward of every family on a one-rank NCCL process
    group and a (1, 1) ("data", "model") DeviceMesh against the
    single-device path, then the fully sharded and compressed-gradient train
    steps on it. Returns its launch counts: one flash_prefill per layer per
    dense or MoE prefill and one rwkv6_chunk per layer per rwkv6 prefill,
    TP_PREFILLS prefills in the TP and in the single-device run each."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tensor_parallel as TP

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1, device_id=(torch.device("cuda", torch.cuda.current_device())
                                     if device == "cuda" else None))
        try:
            mesh = init_device_mesh(device, (1, 1),
                                    mesh_dim_names=("data", "model"))
            pc = ParallelConfig.from_mesh(mesh)
            ops.reset_launch_counts()
            TP.reset_collective_counts()
            tp_forward_check(CELL_ARCH, "float32", TP_F32_LAYERS, mesh, pc,
                             TP_F32_REL_TOL, TP_GRAD_REL_TOL, device)
            free()
            tp_forward_check(CELL_ARCH, "", 0, mesh, pc, MODEL_REL_TOL,
                             MODEL_REL_TOL, device)
            free()
            tp_forward_check("granite-moe-3b-a800m", "float32", TP_F32_LAYERS,
                             mesh, pc, TP_F32_REL_TOL, TP_GRAD_REL_TOL, device)
            free()
            for arch in TP_FAMILIES:
                layers = 0 if arch == "whisper-base" else TP_F32_LAYERS
                tp_forward_check(arch, "float32", layers, mesh, pc,
                                 TP_F32_REL_TOL, TP_GRAD_REL_TOL, device)
                free()
                tp_forward_check(arch, "", 0, mesh, pc, MODEL_REL_TOL,
                                 None if arch in TP_BF16_GRADS_REPORTED
                                 else MODEL_REL_TOL, device)
                free()
            for arch, layers in TP_TRAIN:
                for layout, compress in (("fsdp", False), ("tp", True)):
                    tp_train_check(arch, layers, mesh, layout, compress, device)
                    free()
            # the fully sharded layout's gather, whose gradient is a
            # reduce-scatter, through NCCL (at dp 1 no leaf is sharded)
            x = torch.randn(4, 8, device=device, requires_grad=True)
            y = TP.gather_scatter(x, mesh.get_group("data"), 0)
            y.backward(torch.full_like(y, 3.0))
            check(torch.equal(y, x) and bool((x.grad == 3.0).all()),
                  "gather_scatter on one rank is not the identity")
            counts = ops.launch_counts()
            calls = TP.collective_counts()
        finally:
            dist.destroy_process_group()
    free()
    runs = 2 * TP_PREFILLS     # the TP and the one-device run's prefills
    n_prefill = runs * (2 * TP_F32_LAYERS + get_config(CELL_ARCH).num_layers)
    n_rwkv = runs * (TP_F32_LAYERS + get_config("rwkv6-7b").num_layers)
    log(f"[tp forward] launches {counts}; tensor-parallel collectives issued "
        f"(every one through NCCL) {calls}")
    check(counts == {"paged_attention": 0, "flash_prefill": n_prefill,
                     "rwkv6_chunk": n_rwkv},
          f"tp forward launches {counts}: one flash_prefill per layer per "
          f"dense or MoE prefill expected ({n_prefill}), one rwkv6_chunk per "
          f"layer per rwkv6 prefill ({n_rwkv})")
    check(all(calls.get(k, 0) > 0 for k in ("all_reduce", "all_gather_into_tensor",
                                            "reduce_scatter_tensor")),
          f"the TP forward left a collective unissued: {calls}")
    return counts


def flash_prefill_at_32k(cell, args) -> dict:
    """flash_prefill on layer 0's q/k/v of the prefill cell's prompt (S =
    32768) against its plain version over query blocks of FLASH_BLOCK rows
    (``q_offset``, keys up to the block's end); then its time beside
    torch's SDPA and the bound. Not counted: these launches only compare."""
    from repro_torch.models import layers as Lyr

    model, params, toks = cell.model, args[0], args[1]
    pp = {k: v[0] for k, v in params["blocks"].items()}
    with torch.no_grad():
        x = model.embed_tokens(params, toks)
        h = Lyr.rmsnorm(x, pp["ln1"][0], model.cfg.norm_eps)
        pos = Lyr.causal_positions(toks.shape[1], toks.shape[0], toks.device)
        q, k, v = model._qkv(pp, 0, h, pos, "global")
        q, k, v = q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2)
        del x, h
        B, G, S, R, hd = q.shape
        grid = flash_prefill.grid(q)
        lib_rows = build.load("flash_prefill").flash_prefill_block_rows(hd, 1)
        check(lib_rows == flash_prefill.block_rows(q.dtype, hd),
              f"flash_prefill.grid's {flash_prefill.block_rows(q.dtype, hd)} "
              f"rows per block, the library launches {lib_rows}")
        check(grid[1] <= GRID_Y_MAX, f"flash_prefill's grid {grid} passes "
              f"gridDim.y's {GRID_Y_MAX}")
        out = ops.flash_prefill(q, k, v, causal=True)
        tol = TOL[("flash_prefill", torch.bfloat16)]
        f32 = 2 * TOL[("flash_prefill", torch.float32)]
        q32, k32, v32 = upcast((q, k, v))
        err, ok, worst = 0.0, True, (0.0, 0, 0.0)
        for lo in range(0, S, FLASH_BLOCK):
            hi = lo + FLASH_BLOCK
            # the plain version on bf16 inputs computes in f32 and rounds at
            # the end: want32 rounded is its bf16 result
            want32 = ref.flash_prefill_ref(q32[:, :, lo:hi], k32[:, :, :hi],
                                           v32[:, :, :hi], causal=True,
                                           q_offset=lo)
            want = want32.to(torch.bfloat16).float()
            got = out[:, :, lo:hi].float()
            err = max(err, max_err(got, want))
            ok &= bool(((got - want).abs() <= tol + tol * want.abs()).all())
            # held per block to the f32 result rounded once, so that the
            # late blocks' small outputs (keys up to 32768) are held too
            d = (got - want32).abs()
            ratio = float((d / (BF16_HALF_ULP * want32.abs() + f32)).max())
            if ratio >= worst[0]:
                worst = (ratio, lo, float(d.max() / want32.abs().max()))
            del want32, want, got, d
        del q32, k32, v32
        log(f"[cells] flash_prefill at S {S}, qwen3 layer 0's q/k/v "
            f"{list(q.shape)} bf16, against its plain version over query "
            f"blocks of {FLASH_BLOCK} with q_offset: max_abs_err {err:.3e} "
            f"(atol = rtol = {tol:g}); grid {grid}, y under {GRID_Y_MAX}")
        log(f"[cells] flash_prefill at S {S} vs the f32 result, per block: worst "
            f"error {worst[0]:.3f} of half a bf16 ulp + {f32:g}, in the block at "
            f"query {worst[1]} (max abs error {worst[2]:.3e} of that block's "
            f"largest |want|)")
        check(ok, "flash_prefill at S 32768 disagrees with its plain version")
        check(worst[0] <= 1.0, f"flash_prefill at S 32768, block at query "
              f"{worst[1]}: bf16 output is not the f32 result rounded once")
        pairs = S * (S + 1) // 2 * R * B * G
        flops = 4 * hd * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        ms = cuda_time_ms(lambda: ops.flash_prefill(q, k, v, causal=True),
                          iters=5, warmup=1)
        qh = q.permute(0, 1, 3, 2, 4).reshape(B, G * R, S, hd)
        lib = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, k, v, is_causal=True, enable_gqa=True), iters=5, warmup=1)
    rec = {"ms": ms, "library_ms": lib, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "max_abs_err": err, "S": S}
    log(f"[cells] flash_prefill at S {S} (one layer of the prefill cell): "
        f"kernel {ms:.4f} ms, sdpa {lib:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"(flops {flops}, bytes {nbytes}); {nvidia_smi_line()}")
    return rec


def run_cell_steps(fn, steps: int, warm: bool = True) -> tuple:
    """A warm-up call of ``fn`` (unless ``warm`` is False), then ``steps``
    timed ones (host clock around torch.cuda.synchronize()). Returns (the
    last output, seconds per step, peak bytes allocated since the warm-up,
    launches in one step). Each step takes the same arguments, so the last
    step's output is let go before the next (a train step's new parameters,
    a prefill's cache: GiBs the step itself does not hold)."""
    if warm:
        out, _ = sync_seconds(fn)
        del out
        torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(steps):
        out = None
        before = ops.launch_counts()
        out, dt = sync_seconds(fn)
        secs.append(dt)
        after = ops.launch_counts()
        if i == 0:
            one = {k: after[k] - before[k] for k in after}
    return out, secs, torch.cuda.max_memory_allocated(), one


def cell_outputs(kind: str, out):
    """The tensors a cell's step gives back: (logits, and a prefill's
    cache), or a train step's loss and grad norm."""
    if kind == "train":
        m = out[2] if isinstance(out, tuple) else out
        return [m["loss"], m["grad_norm"]]
    return [out[0]] + (tree_flatten(out[1])[1] if kind == "prefill" else [])


def phase_cells(device="cuda") -> tuple:
    """qwen3-1.7b's prefill_32k, decode_32k and train_4k cells (CELLS) built
    by launch/cells.py, run for real at full width and depth in bf16 on
    random weights from SEED through the kernels (use_kernels): each step
    eager (the cell's function) and captured (``CellStep``: a warm-up, a
    real step, then one CUDA graph replayed; train_4k through the captured
    train step, grad_accum 2), each timed beside roofline_row's bound at
    its cut shape, with the capture seconds, graph pool and peak memory.
    A prefill's or decode's replay equals its eager step bit for bit.
    Returns (the path's launch counts, flash_prefill's record at S
    32768)."""
    card = nvidia_smi_line()
    rows = []
    built = {}
    for name, S, B, cut in CELLS:
        kind = {"prefill_32k": "prefill", "decode_32k": "decode"}.get(name, "train")
        built[name] = ShapeConfig(name, kind, S, B)
    # the comparison launches come before the counters are set to 0
    pre = use_kernels(build_cell(CELL_ARCH, "prefill_32k", None,
                                 shape=built["prefill_32k"]))
    pre_args = materialize(pre, device, SEED)
    flash = flash_prefill_at_32k(pre, pre_args)
    free()
    ops.reset_launch_counts()
    counted = {k: 0 for k in ops.launch_counts()}
    for name, S, B, cut in CELLS:
        shape = built[name]
        kind = "serve" if shape.kind == "decode" else shape.kind
        if kind == "prefill":
            cell, args = pre, pre_args
            del pre, pre_args
        else:
            cell = use_kernels(build_cell(CELL_ARCH, name, None, shape=shape))
            args = materialize(cell, device, SEED)
        out, secs, peak, one = run_cell_steps(lambda: cell.fn(*args),
                                              CELL_EAGER_STEPS)
        for k in counted:
            counted[k] += one[k] * (CELL_EAGER_STEPS + 1)
        want = [x.clone() for x in cell_outputs(kind, out)]
        if kind == "prefill":
            lg, cache = out
            check(tuple(lg.shape) == (B, cell.model.cfg.vocab_size)
                  and bool(torch.isfinite(lg.float()).all()), f"{name}: logits")
            check(one == {"paged_attention": 0, "rwkv6_chunk": 0,
                          "flash_prefill": cell.model.cfg.num_layers},
                  f"{name}: launches per prefill {one}")
            what = f"logits {list(lg.shape)} finite, cache k_full {list(cache['k_full'].shape)}"
        elif kind == "serve":
            lg = out[0]     # its cache (28 GiB) goes with ``out`` below
            check(tuple(lg.shape) == (B, cell.model.cfg.vocab_size)
                  and bool(torch.isfinite(lg.float()).all()), f"{name}: logits")
            check(not any(one.values()), f"{name}: launches per step {one}")
            what = f"logits {list(lg.shape)} finite"
        else:
            loss = float(out[2]["loss"])
            check(math.isfinite(loss) and not any(one.values()),
                  f"{name}: loss {loss}, launches {one}")
            what = f"loss {loss:.4f}, grad norm {float(out[2]['grad_norm']):.4f}"
        out = lg = cache = None
        free()

        # captured: the warm-up (a real step) and the capture, then replays
        torch.cuda.reset_peak_memory_stats()
        cs, first_s = sync_seconds(lambda: CellStep(cell, args))
        c_out, c_secs, c_peak, c_one = run_cell_steps(cs.step, CELL_STEPS,
                                                      warm=False)
        pool = graphs.pool_bytes(cs.pool)
        for k in counted:
            counted[k] += c_one[k] * CELL_STEPS
        got = cell_outputs(kind, c_out)
        check(c_one == one, f"{name}: launches per replay {c_one}, per eager "
                            f"step {one}")
        check(all(bool(torch.isfinite(x.float()).all()) for x in got),
              f"{name}: a captured step's output is not finite")
        if kind == "train":
            same = "not compared (each step moves the state)"
        else:
            equal = len(got) == len(want) and all(
                torch.equal(a, b) for a, b in zip(got, want))
            same = f"equal to the eager step's bit for bit: {equal}"
            check(equal, f"{name}: the captured step's outputs differ from "
                         f"the eager step's")
        capture_s = cs.capture_s
        del cs, c_out, got, want
        args = None
        free()

        t, tc = float(np.median(secs)), float(np.median(c_secs))
        row = roofline_row(CELL_ARCH, name, None, shape=shape)
        bound = row["step_time_bound_s"]
        rec = {"cell": name, "reduced": cut, "seq_len": S, "batch": B,
               "step_s": tc, "step_s_min": min(c_secs),
               "eager_step_s": t, "eager_step_s_min": min(secs),
               "steps": CELL_STEPS, "eager_steps": CELL_EAGER_STEPS,
               "first_s": first_s, "capture_s": capture_s,
               "pool_bytes": pool, "peak_bytes": c_peak, "eager_peak_bytes": peak,
               "compute_term_s": row["compute_term_s"],
               "memory_term_s": row["memory_term_s"],
               "collective_term_s": row["collective_term_s"],
               "bound_s": bound, "bound_by": row["bottleneck"],
               "model_flops": row["model_flops_global"],
               "dot_flops": row["dot_flops_per_device"],
               "mfu": row["model_flops_global"] / (PEAK_FLOPS * tc),
               "eager_mfu": row["model_flops_global"] / (PEAK_FLOPS * t),
               "bound_share": bound / tc, "eager_bound_share": bound / t,
               "card": card}
        rows.append(rec)
        log(f"[cells] {CELL_ARCH} {name} ({cut}; {S} tokens x {B}) on {card}: "
            f"captured step {tc * 1e3:.2f} ms (median of {CELL_STEPS} replays; "
            f"min {min(c_secs) * 1e3:.2f}), eager {t * 1e3:.2f} ms (median of "
            f"{CELL_EAGER_STEPS} after a warm-up; min {min(secs) * 1e3:.2f}); first "
            f"captured call (a real step, then the capture) {first_s:.3f}s, of "
            f"it the capture {capture_s:.3f}s; graph pool {gib(pool)}; peak "
            f"{c_peak / 2**30:.2f} GiB captured, {peak / 2**30:.2f} eager; "
            f"bound {bound * 1e3:.2f} ms ({row['bottleneck']}: compute "
            f"{row['compute_term_s'] * 1e3:.2f} ms, memory "
            f"{row['memory_term_s'] * 1e3:.2f} ms, collective "
            f"{row['collective_term_s'] * 1e3:.2f} ms); model FLOPs "
            f"{row['model_flops_global']:.4e}, dot FLOPs "
            f"{row['dot_flops_per_device']:.4e}; mfu {rec['mfu']:.4f} "
            f"(eager {rec['eager_mfu']:.4f}), bound_share "
            f"{rec['bound_share']:.4f} (eager {rec['eager_bound_share']:.4f}); "
            f"{what}; captured outputs {same}")
        del cell
        free()
    check(ops.launch_counts() == counted,
          f"cells launches {ops.launch_counts()} vs per-step counts {counted}")
    log("[cells] json " + json.dumps({"cells": rows}))
    return counted, flash


class DryRun:
    """``python -m repro_torch.launch.dryrun --arch A`` on the (16, 16) mesh
    and with ``--multi-pod`` on (2, 16, 16) (the rows of ``--both-meshes``)
    for each of DRYRUN_ARCHS: two subprocesses per arch, each mesh on a fake
    process group, each cell composed from two and three layers. They trace
    on the CPU alone (no card visible: fake CPU tensors, no device memory)
    at the lowest priority, so they run beside the card's phases from the
    start (the rwkv6 and hymba train rows take minutes of host time);
    ``finish`` (phase 23, before the cells, whose steps are timed on the
    host) waits for them and holds every row ok, or skipped where
    supports_shape says so, and every ok row's peak positive and no lower
    than either of its two traced peaks."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   CUDA_VISIBLE_DEVICES="")
        self.procs = {}
        for arch in DRYRUN_ARCHS:
            for pod in ("", ".pod"):
                out = os.path.join(self.tmp, f"{arch}{pod}")
                with open(out + ".log", "w") as logf:
                    p = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--out", out + ".json"]
                        + (["--multi-pod"] if pod else []),
                        env=env, stdout=logf, stderr=subprocess.STDOUT)
                os.setpriority(os.PRIO_PROCESS, p.pid, 19)
                self.procs[arch, pod] = p

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self) -> None:
        from repro_torch.configs import get_shape

        t_wait = time.perf_counter()
        for (arch, pod), p in self.procs.items():
            p.wait(timeout=600)
            out = os.path.join(self.tmp, f"{arch}{pod}")
            with open(out + ".log") as f:
                text = f.read()
            check(p.returncode == 0, f"dry run of {arch}{pod} failed: {text[-3000:]}")
        for arch in DRYRUN_ARCHS:
            rows = []
            for pod in ("", ".pod"):
                with open(os.path.join(self.tmp, f"{arch}{pod}.json")) as f:
                    rows += json.load(f)
            cfg = get_config(arch)
            check(len(rows) == 8, f"{arch}: {len(rows)} dry-run rows")
            for r in rows:
                skip = not cfg.supports_shape(get_shape(r["shape"]))
                check(r["status"] == ("skipped" if skip else "ok"),
                      f"{arch} {r['shape']} {r['mesh']}: {r['status']} "
                      f"{r.get('error')}")
                if r["status"] == "ok":
                    peak, traced = (r["peak_bytes_per_device"],
                                    r["traced_peak_bytes"] or [])
                    check(peak > 0 and peak >= max(traced, default=0),
                          f"{arch} {r['shape']} {r['mesh']}: peak {peak} B "
                          f"below its traced peaks {traced}")
                    log(f"[dryrun] {arch} {r['shape']} {r['mesh']}: peak "
                        f"{peak / 1e9:.2f} GB/device ({r['trace']}"
                        + "".join(f"; {n} layers {b / 1e9:.2f} GB" for n, b in
                                  zip(r["composed_from"] or [], traced))
                        + "), dot FLOPs "
                        f"{r['dot_flops_per_device']:.4e}/device, collectives "
                        f"{r['collective_counts']}, wire bytes "
                        f"{sum(r['collective_wire_bytes'].values()):.4e}, "
                        f"collective time at the assumed links "
                        f"{r['collective_seconds'] * 1e3:.2f} ms, traced in "
                        f"{r['lower_s']} s")
                else:
                    log(f"[dryrun] {arch} {r['shape']} {r['mesh']}: skipped "
                        f"({r['reason']})")
        log(f"[dryrun] {len(DRYRUN_ARCHS)} archs x 8 rows in "
            f"{time.perf_counter() - self.t0:.1f}s since they started, "
            f"{time.perf_counter() - t_wait:.1f}s of it waited for here")


def main() -> None:
    t_start = t = time.perf_counter()
    phase_device()
    phase_build()
    t = lap("device and build", t)
    dry = DryRun()
    try:
        phases(t_start, t, dry)
    finally:
        dry.stop()


def phases(t_start: float, t: float, dry: DryRun) -> None:
    errs = phase_kernels()
    t = lap("kernels", t)

    cfg, model, params = load_model("qwen3-1.7b")
    phase_model_paged(cfg, model, params)
    t = lap("qwen3 model", t)
    paths = {"qwen3 serve": phase_serve(model, params)}
    t = lap("qwen3 serve", t)
    phase_graphs(model, params, loops=("serial", "pipelined"))
    t = lap("qwen3 graphs", t)
    paths["qwen3 planned serve"], warm = phase_planned(model, params)
    t = lap("qwen3 planned serve", t)
    phase_profile(model, params, planned=True, warm=warm)
    t = lap("qwen3 planned profile", t)
    del cfg, model, params
    free()

    cfg, model, params = load_model("rwkv6-7b", dtype="float32")
    phase_model_rwkv(cfg, model, params, RWKV_F32_REL_TOL)
    t = lap("rwkv6 model f32", t)
    del cfg, model, params
    free()

    cfg, model, params = load_model("rwkv6-7b")
    n = RWKV_BF16_LAYERS
    phase_model_rwkv(cfg.replace(num_layers=n), *first_layers(model, params, n),
                     MODEL_REL_TOL)
    phase_layers_rwkv(cfg, model, params)
    phase_model_rwkv(cfg, model, params, None)
    t = lap("rwkv6 model bf16", t)
    rwkv_shapes = collections.Counter()
    paths["rwkv6 serve"] = phase_serve(model, params, exact=True,
                                       rwkv_shapes=rwkv_shapes)
    log("[serve] rwkv6-7b rwkv6_chunk calls by (B, S, chunk): " + ", ".join(
        f"{key}: {n}" for key, n in sorted(rwkv_shapes.items())))
    t = lap("rwkv6 serve", t)
    phase_graphs(model, params)
    t = lap("rwkv6 graphs", t)
    del cfg, model, params
    free()

    paths["granite serve"], t = path_granite(t)
    paths["qwen3-moe serve"], t = path_qwen3_moe(t)
    paths["qwen2.5-32b serve"], t = path_large_dense("qwen2.5-32b", t,
                                                     graphs_too=True)
    paths["internvl2-26b serve"], t = path_large_dense("internvl2-26b", t,
                                                       graphs_too=False)
    t = path_gemma(t)
    paths["hymba serve"], t = path_hymba(t)
    paths["whisper model"], t = path_whisper(t)
    counts = phase_train()
    t = lap("train qwen3", t)
    paths["training"] = {k: counts[k] + v for k, v in
                         phase_train_families().items()}
    t = lap("train families", t)
    paths["multi-device"] = phase_multi_device()
    t = lap("multi-device", t)
    paths["tp forward"] = phase_tp_forward()
    t = lap("tp forward", t)
    dry.finish()
    t = lap("dry run", t)
    # the cells' steps are timed on the host: after the tracing processes
    paths["cells"], flash_32k = phase_cells()
    t = lap("cells", t)

    kernels = phase_times(errs, paths, flash_32k, rwkv_shapes)
    t = lap("times", t)
    log_graph_rows(nvidia_smi_line())
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
