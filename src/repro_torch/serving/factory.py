"""One place to assemble serving stacks: ``build_simulated_cluster`` for the
simulated multi-replica clock (per replica a private PrefixCache, a scheduler
wired to it, and a SimulatedExecutor sharing the same cache; no model and no
torch device) and ``build_real_engine``, which pairs the paper's scheduler
(or a baseline) with a PyTorch executor on either KV backend (dense slots or
the block-paged pool). Every decoder-only family serves on the dense backend
(the dense and MoE transformers, RWKV6, hymba); the paged backend takes the
transformers whose layers are all full attention (not gemma3, RWKV6 or
hymba). whisper-base, an encoder-decoder, has no engine path, as in the
reference."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.latency_model import BatchLatencyModel, a100_opt13b
from repro_torch.core.policies import SCHEDULERS
from repro_torch.core.priority import BatchLimits, DPUConfig
from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.engine.simulator import SimulatedExecutor
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.router import Router


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Without a card that raises: the caller must ask
    for the CPU explicitly (``device="cpu"``); nothing falls back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_simulated_cluster(num_replicas: int, scheduler: str = "relserve",
                            router_policy: str = "affinity_spill",
                            latency_model: Optional[BatchLatencyModel] = None,
                            limits: Optional[BatchLimits] = None,
                            dpu_config: Optional[DPUConfig] = None,
                            seed: int = 0, block_size: int = 16,
                            router: Optional[Router] = None,
                            kv_admission: str = "conservative",
                            prefix_sharing: bool = False,
                            engine_loop: str = "serial",
                            kv_tiering: bool = False, host_kv_cap: int = 0,
                            swap_bandwidth_gbps: float = 32.0,
                            proactive_offload: bool = False,
                            idle_horizon_s: Optional[float] = None,
                            swap_prefetch: bool = False,
                            debug_invariants: bool = False,
                            snapshot_every: int = 0) -> Cluster:
    lm = latency_model or a100_opt13b()
    caches = {}

    def make_scheduler(i: int):
        caches[i] = PrefixCache(block_size=block_size)
        kw = dict(limits=limits or BatchLimits(), latency_model=lm,
                  prefix_cache=caches[i], kv_admission=kv_admission,
                  prefix_sharing=prefix_sharing)
        if kv_tiering:
            kw.update(kv_tiering=True, host_kv_cap=host_kv_cap,
                      swap_bandwidth_gbps=swap_bandwidth_gbps,
                      proactive_offload=proactive_offload,
                      idle_horizon_s=idle_horizon_s,
                      swap_prefetch=swap_prefetch)
        if scheduler.startswith("relserve"):
            kw["dpu_config"] = dpu_config or DPUConfig()
        return SCHEDULERS[scheduler](**kw)

    def make_executor(i: int):
        return SimulatedExecutor(lm, prefix_cache=caches[i], seed=seed + i,
                                 swap_bandwidth_gbps=swap_bandwidth_gbps)

    return Cluster(make_scheduler, make_executor, num_replicas,
                   router=router or Router(num_replicas, policy=router_policy),
                   engine_loop=engine_loop, debug_invariants=debug_invariants,
                   snapshot_every=snapshot_every)


def build_real_engine(arch: str = "qwen3-1.7b", scheduler: str = "relserve",
                      kv_backend: str = "dense", *,
                      limits: Optional[BatchLimits] = None,
                      latency_model: Optional[BatchLatencyModel] = None,
                      dpu_config: Optional[DPUConfig] = None,
                      kv_admission: str = "conservative",
                      prefix_sharing: bool = False,
                      max_slots: int = 32, max_len: int = 512,
                      block_size: int = 16, num_blocks: Optional[int] = None,
                      seed: int = 0, model=None, params=None,
                      engine_loop: str = "serial",
                      kv_tiering: bool = False, host_kv_cap: int = 0,
                      swap_bandwidth_gbps: float = 32.0,
                      proactive_offload: bool = False,
                      idle_horizon_s: Optional[float] = None,
                      swap_prefetch: bool = False,
                      debug_invariants: bool = False,
                      device=None, **executor_kw):
    """A single-replica real serving engine on the chosen KV backend.

    ``kv_backend='dense'`` is the per-slot baseline, for any ported family;
    ``'paged'`` runs the block-paged executor (BlockManager pools +
    paged-attention decode), with physically shared prefix blocks whenever
    the scheduler runs with ``prefix_sharing=True``, and raises
    ``NotImplementedError`` for a model without paged KV (gemma3's window
    layers, RWKV6, hymba). Either backend raises it for whisper. Without ``model``/``params`` the arch's smoke
    config is built with random weights from ``seed`` on ``device``; passed
    ``params`` must already live on ``device``. ``device=None`` means CUDA
    (see ``resolve_device``).
    """
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.engine import ServingEngine
    from repro_torch.engine.executor import make_real_executor
    from repro_torch.models.registry import build_model

    dev = resolve_device(device)
    if model is None:
        model = build_model(get_smoke_config(arch))
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    elif params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"engine device is {dev}")
    pc = PrefixCache(block_size=block_size)
    limits = limits or BatchLimits()
    if num_blocks is None and kv_backend == "paged":
        # The scheduler charges the cap in raw tokens while the pool hands
        # out whole blocks — size the pool to cover the cap plus one block
        # of per-sequence rounding waste for a full decode batch, and never
        # below the dense layout's physical capacity.
        dense_equiv = -(-max_slots * max_len // block_size)
        cap_blocks = -(-limits.cap // block_size) + limits.max_num_seqs
        num_blocks = max(dense_equiv, cap_blocks)
    kw = dict(limits=limits, prefix_cache=pc,
              kv_admission=kv_admission, prefix_sharing=prefix_sharing)
    if kv_tiering:
        kw.update(kv_tiering=True, host_kv_cap=host_kv_cap,
                  swap_bandwidth_gbps=swap_bandwidth_gbps,
                  proactive_offload=proactive_offload,
                  idle_horizon_s=idle_horizon_s,
                  swap_prefetch=swap_prefetch)
    if latency_model is not None:
        kw["latency_model"] = latency_model
    if scheduler.startswith("relserve"):
        kw["dpu_config"] = dpu_config or DPUConfig()
    sched = SCHEDULERS[scheduler](**kw)
    num_host_blocks = 0
    if kv_tiering and kv_backend == "paged":
        # whole-block rounding: each swapped sequence wastes < 1 block
        num_host_blocks = -(-host_kv_cap // block_size) + limits.max_num_seqs
    ex = make_real_executor(kv_backend, model, params, max_slots=max_slots,
                            max_len=max_len, prefix_cache=pc,
                            num_blocks=num_blocks, block_size=block_size,
                            share_prefix_blocks=prefix_sharing,
                            num_host_blocks=num_host_blocks, **executor_kw)
    return ServingEngine(sched, ex, engine_loop=engine_loop,
                         debug_invariants=debug_invariants)
