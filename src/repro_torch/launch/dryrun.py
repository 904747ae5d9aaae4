"""Multi-pod dry run of the port: trace every (architecture x input-shape)
cell on the production meshes and record memory, FLOP and collective
statistics per device; the counterpart of ``repro/launch/dryrun.py``.

Each mesh lives on a fake process group of 256 or 512 ranks, set up and torn
down per cell (``launch/mesh.py::fake_world``); this process is rank 0 and
traces its own program: at two and three layer groups, the full depth
composed from them (``launch/cells.py::trace_composed``; a trace of every
layer, ``--whole``, takes minutes per train cell at these shapes). The
FLOPs and collectives compose exactly; the peak point by point over the
two step timelines, with DTensor's sharding propagation left out of the
bytes held (``launch/cells.py``'s docstring says why). It reads what a
trace of every layer reads (equal in every cell checked, PERF.md §6) and
never less than the two traced peaks (``traced_peak_bytes``); a cell whose
traces do not compose is a ``failed`` row. The keys that only XLA's
compile gives (``hlo_flops_per_device``, ``hlo_bytes_per_device`` and the
argument / output / temp / alias split of the peak) are ``null``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --whole
Results merge into experiments/dryrun_results_torch.json (``--out``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.cells import trace_composed
from repro_torch.launch.mesh import fake_world, make_production_mesh, production_shape
from repro_torch.launch.roofline import stats_of

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_results_torch.json")


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             *, cfg_override: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, mesh_shape=None,
             device_type: Optional[str] = None, whole: bool = False) -> Dict:
    """One row. ``cfg_override``, ``shape`` and ``mesh_shape`` (dims and
    names) shrink the cell for a small run; ``device_type`` is the fake
    tensors' (default: ``cuda`` where there is a card); ``whole`` traces
    every layer instead of composing (``trace_composed``)."""
    cfg = cfg_override or get_config(arch)
    shape = shape or get_shape(shape_name)
    dims, names = mesh_shape or production_shape(multi_pod)
    row: Dict = {"arch": arch, "shape": shape_name, "mesh": "x".join(map(str, dims)),
                 "kind": shape.kind}
    if not cfg.supports_shape(shape):
        row["status"] = "skipped"
        row["reason"] = "full-attention arch skips long_500k (DESIGN.md §5)"
        return row
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    try:
        with fake_world(math.prod(dims)):
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type=device_type)
            else:
                from torch.distributed.device_mesh import init_device_mesh
                mesh = init_device_mesh(device_type, dims, mesh_dim_names=names)
            trace = trace_composed(arch, shape_name, mesh, cfg, shape=shape,
                                   whole=whole)
        stats = stats_of(trace)
        colls = trace.collectives
        row.update({
            "status": "ok",
            "trace": (f"composed from {trace.composed_from[0]} and "
                      f"{trace.composed_from[1]} layers"
                      if trace.composed_from else "full"),
            "composed_from": list(trace.composed_from or ()) or None,
            "traced_peak_bytes": list(trace.traced_peaks or ()) or None,
            "lower_s": round(trace.seconds, 2),
            "compile_s": None,
            "argument_bytes_per_device": None,
            "output_bytes_per_device": None,
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": None,
            "peak_bytes_per_device": trace.peak_bytes,
            "hlo_flops_per_device": None,
            "dot_flops_per_device": trace.dot_flops,
            "hlo_bytes_per_device": None,
            "collective_out_bytes": dict(colls.out_bytes),
            "collective_wire_bytes": {k: round(v) for k, v in colls.wire_bytes.items()},
            "collective_counts": dict(colls.counts),
            "collective_seconds": stats.coll_time_s,
            "num_devices": int(math.prod(dims)),
        })
        if verbose:
            print(f"  peak {trace.peak_bytes / 1e9:.2f} GB/device, dot flops "
                  f"{trace.dot_flops:.3e}, collectives {dict(colls.counts)}")
    except Exception as e:  # noqa: BLE001 — a failing cell is a reportable bug
        row["status"] = "failed"
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc(limit=8)
    return row


def save_rows(rows, path: str = RESULTS_PATH) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    keyed = {(r["arch"], r["shape"], r["mesh"]): r for r in existing}
    for r in rows:
        keyed[(r["arch"], r["shape"], r["mesh"])] = r
    with open(path, "w") as f:
        json.dump(list(keyed.values()), f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already ok/skipped in the results file")
    ap.add_argument("--whole", action="store_true",
                    help="trace every layer (minutes per train cell) instead "
                         "of composing from two and three layer groups")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    done = set()
    out_abs = os.path.abspath(args.out)
    if args.resume and os.path.exists(out_abs):
        with open(out_abs) as f:
            for r in json.load(f):
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    rows = []
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape, mesh_name) in done:
                    continue
                tag = f"{arch} x {shape} x {mesh_name}"
                print(f"[dryrun] {tag}", flush=True)
                row = run_cell(arch, shape, mp, whole=args.whole)
                rows.append(row)
                if row["status"] == "failed":
                    n_fail += 1
                    print(f"  FAILED: {row['error']}", flush=True)
                elif row["status"] == "skipped":
                    print(f"  skipped: {row['reason']}", flush=True)
                else:
                    print(f"  ok (trace {row['lower_s']}s, "
                          f"peak {row['peak_bytes_per_device']/1e9:.2f} GB/device)",
                          flush=True)
                save_rows(rows, args.out)
    print(f"\n{len(rows)} cells, {n_fail} failures")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
