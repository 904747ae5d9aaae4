"""Roofline bounds of a step from a traced cell, the port's counterpart of
``repro/launch/roofline.py``, at an NVIDIA H100 SXM's peaks.

Three terms per (arch x shape x mesh), in seconds per step:
  compute    = dot FLOPs per device / PEAK_FLOPS     (the traced rank's products)
  memory     = analytic bytes per device / HBM_BW    (weights, cache, activations)
  collective = sum over collectives of wire bytes / the group's link rate

The link rate of a collective is NVLink's (``NVLINK_BW``) when every rank of
its group sits on one 8-card node, and the network's per card (``NET_BW``)
otherwise: a ``model`` axis of 16 spans two nodes. ``NET_BW`` is an
assumption (one 400 Gb/s NIC per card), not a measurement.

A trace counts every layer it runs, so the reference's scan-body
correction is not needed: ``corrected_stats`` returns ``scan_corrected:
False`` with the reference's keys. Its trace is ``cells.trace_composed``'s:
a deep model's full depth composed from traces at two and three layer
groups, which ``composed_from`` names (None: traced whole). The XLA-only
figures (``xla_flops``, ``xla_bytes``) have no counterpart and are ``None``.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.cells import build_cell, trace_composed
from repro_torch.launch.hlo_stats import wire_bytes

PEAK_FLOPS = 989e12     # bf16 dense, per card: NVIDIA H100 SXM, 700 W data sheet
HBM_BW = 3.35e12        # bytes/s per card: NVIDIA H100 SXM, 700 W data sheet
NVLINK_BW = 450e9       # bytes/s each way per card within a node: NVIDIA H100 SXM, 700 W data sheet
NET_BW = 50e9           # bytes/s per card across nodes: assumed, one 400 Gb/s NIC


@dataclass
class CellStats:
    dot_flops: float
    xla_flops: Optional[float]
    xla_bytes: Optional[float]
    coll_wire: float
    coll_out: float
    coll_time_s: float      # sum of each collective's wire bytes / its link rate


def link_bw(intra_node: bool) -> float:
    return NVLINK_BW if intra_node else NET_BW


def stats_of(trace) -> CellStats:
    secs = sum(wire_bytes(r.kind, r.out_bytes, r.group_size) / link_bw(r.intra_node)
               for r in trace.records)
    return CellStats(trace.dot_flops, None, None,
                     trace.collectives.total_wire_bytes,
                     float(trace.collectives.total_out_bytes), secs)


def corrected_stats(arch: str, shape_name: str, mesh,
                    dryrun_row: Optional[Dict] = None, *,
                    cfg_override: Optional[ModelConfig] = None,
                    shape: Optional[ShapeConfig] = None) -> Dict:
    """The traced cell's totals (a dry-run row's, when one is given).
    ``cfg_override`` and ``shape`` cut the cell as ``build_cell``'s do."""
    cell = build_cell(arch, shape_name, mesh, cfg_override=cfg_override,
                      shape=shape)
    if dryrun_row is not None:
        full = CellStats(
            dryrun_row["dot_flops_per_device"], None, None,
            float(sum(dryrun_row["collective_wire_bytes"].values())),
            float(sum(dryrun_row["collective_out_bytes"].values())),
            dryrun_row["collective_seconds"])
        peak = dryrun_row["peak_bytes_per_device"]
        composed_from = dryrun_row.get("composed_from")
    else:
        trace = trace_composed(arch, shape_name, mesh, cfg_override, shape=shape)
        full = stats_of(trace)
        peak = trace.peak_bytes
        composed_from = trace.composed_from
    return {
        "arch": arch, "shape": shape_name,
        "n_groups": cell.model.scan_trip_count,
        "peak_bytes_per_device": peak,
        "scan_corrected": False,
        "composed_from": list(composed_from) if composed_from else None,
        "stats": asdict(full),
        "stats_uncorrected": asdict(full),
    }


# --------------------------------------------------------------------------
# analytic models (per-device; global figures divided by device count)
# --------------------------------------------------------------------------
def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global MODEL_FLOPS: the spec's 6·N·D / 6·N_active·D parameter term plus
    an attention-context term reported separately (decode reads O(S) cache)."""
    n = cfg.num_params()
    n_act = cfg.num_active_params()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        param_term = 6.0 * n_act * tokens
        attn_mult = 3.0      # fwd + bwd
        ctx = S / 2          # causal average context
    elif shape.kind == "prefill":
        tokens = B * S
        param_term = 2.0 * n_act * tokens
        attn_mult = 1.0
        ctx = S / 2
    else:  # decode: one token per sequence against an S-token context
        tokens = B
        param_term = 2.0 * n_act * tokens
        attn_mult = 1.0
        ctx = S
    if cfg.attn_kind == "linear":
        attn = 0.0           # rwkv context cost folded into its param projections
    else:
        L_attn = cfg.num_layers
        window = cfg.sliding_window
        if cfg.attn_kind == "local_global" and window:
            n_local = cfg.num_layers * cfg.local_global_pattern // (cfg.local_global_pattern + 1)
            n_global = cfg.num_layers - n_local
            eff_ctx = (n_local * min(ctx, window) + n_global * ctx) / cfg.num_layers
        elif cfg.attn_kind == "swa" and window:
            eff_ctx = min(ctx, window)
        else:
            eff_ctx = ctx
        attn = attn_mult * 4.0 * tokens * cfg.num_heads * cfg.head_dim * eff_ctx * L_attn
    return {"param_flops": param_term, "attn_flops": attn,
            "model_flops": param_term + attn}


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig, model,
                          n_devices: int, tp: int) -> float:
    """Per-device HBM traffic lower bound for one step (bf16 storage)."""
    param_bytes = model.param_count() * 2 / tp     # weights read once
    B = shape.global_batch
    dp = max(1, n_devices // tp)
    if shape.is_decode:
        try:
            cache = model.cache_struct(B, shape.seq_len)
            cache_bytes = sum(
                math.prod(s.shape) * s.dtype.itemsize
                for s in cache.values()) / n_devices
        except Exception:
            cache_bytes = 0.0
        return param_bytes + cache_bytes           # read cache once + weights
    act = B * shape.seq_len * cfg.d_model * 2 * cfg.num_layers * 4 / n_devices
    if shape.kind == "train":
        opt = model.param_count() * 4 * 3 * 2 / n_devices   # m,v,master r+w (ZeRO)
        return param_bytes * 2 + opt + act * 3
    return param_bytes + act


def mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape)) if mesh is not None else "1"


def roofline_row(arch: str, shape_name: str, mesh, dryrun_row: Optional[Dict] = None,
                 cell_stats: Optional[Dict] = None, *,
                 cfg_override: Optional[ModelConfig] = None,
                 shape: Optional[ShapeConfig] = None) -> Dict:
    """The reference's row at the H100's peaks; ``mesh`` None is one card."""
    cfg = cfg_override or get_config(arch)
    shape = shape or get_shape(shape_name)
    n_dev = mesh.size() if mesh is not None else 1
    cs = cell_stats or corrected_stats(arch, shape_name, mesh, dryrun_row=dryrun_row,
                                       cfg_override=cfg_override, shape=shape)
    stats = cs["stats"]
    cell = build_cell(arch, shape_name, mesh, cfg_override=cfg_override,
                      shape=shape)
    tp = cell.pc.tp

    compute_term = stats["dot_flops"] / PEAK_FLOPS
    mem_bytes = analytic_memory_bytes(cfg, shape, cell.model, n_dev, tp)
    memory_term = mem_bytes / HBM_BW
    collective_term = stats["coll_time_s"]
    model = analytic_model_flops(cfg, shape)
    model_per_dev = model["model_flops"] / n_dev
    terms = {"compute": compute_term, "memory": memory_term,
             "collective": collective_term}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "compute_term_s": compute_term,
        "memory_term_s": memory_term,
        "collective_term_s": collective_term,
        "bottleneck": bottleneck,
        "step_time_bound_s": step_time,
        "dot_flops_per_device": stats["dot_flops"],
        "model_flops_global": model["model_flops"],
        "model_param_flops_global": model["param_flops"],
        "useful_ratio": model_per_dev / stats["dot_flops"] if stats["dot_flops"] else 0.0,
        "analytic_mem_bytes_per_device": mem_bytes,
        "xla_bytes_per_device": stats["xla_bytes"],
        "xla_flops_per_device": stats["xla_flops"],
        "coll_wire_bytes_per_device": stats["coll_wire"],
        "mfu_at_bound": (model_per_dev / PEAK_FLOPS) / step_time if step_time else 0.0,
        "scan_corrected": cs.get("scan_corrected", False),
        "peak_bytes_per_device": cs.get("peak_bytes_per_device", 0),
    }
