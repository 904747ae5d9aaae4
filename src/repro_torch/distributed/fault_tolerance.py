"""Checkpoint/restore + engine-state snapshots, the PyTorch counterpart of
``repro/distributed/fault_tolerance.py``.

Training: per-leaf ``.npy`` files under an atomically published step
directory plus a JSON manifest, in the reference's format, so a checkpoint
written by either package loads in the other bit for bit: leaves in
``jax.tree_util`` order (sorted dict keys; ``None`` is no leaf), numbered
``{tree}__{i:05d}.npy``, with paths such as ``blocks/wq``; bfloat16 stored
as its raw ``uint16`` bits under the logical dtype ``bfloat16``.

Serving: scheduler queues + relQuery progress serialize to JSON; the KV cache
is deliberately NOT checkpointed — it is recomputable via prefix replay, which
the prefix cache makes cheap (DESIGN.md §6). The JSON is byte-identical to
the JAX package's, so a snapshot taken by either restores into the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import numpy_from_tensor, tensor_from_numpy
from repro_torch.core.relquery import RelQuery, Request, RequestState
from repro_torch.models.param_utils import tree_flatten, tree_unflatten


# --------------------------------------------------------------------------
# training checkpoints
# --------------------------------------------------------------------------
def save_checkpoint(path: str, step: int, trees: Dict[str, Any],
                    metadata: Optional[Dict] = None) -> str:
    """Write ``trees`` (e.g. {'params': ..., 'opt': ...}) under path/step_N."""
    final = os.path.join(path, f"step_{step}")
    # The staging dir must live under ``path`` so the final os.replace is a
    # same-filesystem rename: mkdtemp(dir=None) falls back to the system
    # tmpdir, and publishing across filesystems raises EXDEV.
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=path)
    manifest = {"step": step, "metadata": metadata or {}, "trees": {}}
    try:
        for name, tree in trees.items():
            paths, leaves = tree_flatten(tree)
            entries = []
            for i, (p, leaf) in enumerate(zip(paths, leaves)):
                arr = numpy_from_tensor(leaf)     # bf16: raw uint16 bits
                logical_dtype = ("bfloat16" if leaf.dtype == torch.bfloat16
                                 else str(arr.dtype))
                fn = f"{name}__{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                entries.append({"path": p, "file": fn,
                                "shape": list(arr.shape), "dtype": logical_dtype})
            manifest["trees"][name] = entries
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: Optional[int] = None,
                    template_trees: Optional[Dict[str, Any]] = None
                    ) -> Tuple[int, Dict[str, Any]]:
    """Load trees; with ``template_trees``, each tree takes its template's
    structure and each tensor its template leaf's device (otherwise returns
    {name: {leaf_path: tensor}} on the CPU)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, entries in manifest["trees"].items():
        tensors = []
        for e in entries:
            t = tensor_from_numpy(np.load(os.path.join(d, e["file"]),
                                          allow_pickle=False))
            if str(t.dtype).removeprefix("torch.") != e["dtype"]:
                # raw-bit stored bfloat16 (the only such dtype the port has)
                if e["dtype"] != "bfloat16" or t.dtype != torch.uint16:
                    raise ValueError(f"{e['file']}: dtype {e['dtype']} stored "
                                     f"as {t.dtype} is not readable here")
                t = t.view(torch.bfloat16)
            tensors.append(t)
        if template_trees and name in template_trees:
            _, flat = tree_flatten(template_trees[name])
            if len(flat) != len(tensors):
                raise ValueError(f"tree arity mismatch for {name}")
            tensors = [t.to(ref.device) for t, ref in zip(tensors, flat)]
            out[name] = tree_unflatten(template_trees[name], tensors)
        else:
            out[name] = {e["path"]: t for e, t in zip(entries, tensors)}
    return manifest["step"], out


# --------------------------------------------------------------------------
# serving-engine state snapshots
# --------------------------------------------------------------------------
# v2: full queue/ledger/predictor/DPU state with per-request streamed-token
# high-water marks. v1 snapshots (no version field) predate preemption, prefix
# sharing, and the host KV tier and are not restorable.
SNAPSHOT_VERSION = 2

# Scheduler counters that survive a snapshot round-trip (everything a
# ServiceReport reads from the scheduler besides the queues themselves).
_SCHED_COUNTERS = (
    "preemptions", "preempted_tokens", "missing_decode_outputs",
    "shared_tokens_saved", "swap_outs", "swap_ins", "swapped_out_tokens",
    "swapped_in_tokens", "swap_bytes_moved", "reclaim_swap_decisions",
    "reclaim_recompute_decisions", "proactive_offloads", "swap_prefetches",
    "prefetch_cancelled",
)


def _snapshot_request(sched, r: Request) -> Dict:
    return {
        "req_id": r.req_id,
        "tokens": list(r.tokens),
        "max_output_tokens": r.max_output_tokens,
        "eos_token": r.eos_token,
        "sim_output_len": getattr(r, "sim_output_len", None),
        "state": r.state.value,
        "output_tokens": list(r.output_tokens),
        "prefilled": r.prefilled,
        "prefilled_tokens": r.prefilled_tokens,
        "preserved_output_tokens": r.preserved_output_tokens,
        "finish_time": r.finish_time,
        # Predicted-footprint charge (kv_admission=predicted): the charge is
        # prediction-dependent at admission time, so it must travel with the
        # snapshot — recomputing it on restore could disagree with the debit
        # taken when the request finishes.
        "footprint": sched._footprint_of.get(r.req_id),
    }


def snapshot_relquery(sched, rq: RelQuery,
                      delivered: Optional[Dict[str, int]] = None) -> Dict:
    """Serialize one relQuery with full progress state. ``delivered`` maps
    req_id -> tokens already streamed to the client; absent entries default to
    everything generated so far, so a restored replica never re-emits tokens a
    Frontend may have delivered."""
    d = delivered or {}
    snap = {
        "rel_id": rq.rel_id,
        "arrival_time": rq.arrival_time,
        "max_output_tokens": rq.max_output_tokens,
        "template_id": rq.template_id,
        "first_prefill_start": rq.first_prefill_start,
        "last_prefill_end": rq.last_prefill_end,
        "finish_time": rq.finish_time,
        "cancel_time": rq.cancel_time,
        "priority": rq.priority,
        "priority_fresh": rq.priority_fresh,
        "was_all_waiting": rq._was_all_waiting,
        "cache_miss_ratio": rq.cache_miss_ratio,
        "preemptions": rq.preemptions,
        "requests": [_snapshot_request(sched, r) for r in rq.requests],
    }
    for rd in snap["requests"]:
        rd["streamed"] = d.get(rd["req_id"], len(rd["output_tokens"]))
    return snap


def _snapshot_predictor(p) -> Optional[Dict]:
    if p is None:
        return None
    return {"quantile": p.quantile, "window": p.window,
            "observations": p.observations,
            # JSON objects key on strings; template fingerprints are ints
            "obs": {str(k): list(v) for k, v in p._obs.items()}}


def _restore_predictor(sched, d: Optional[Dict]) -> None:
    if d is None:
        return
    p = sched.predictor
    if p is None:
        from repro_torch.core.predictor import OutputLenPredictor
        p = OutputLenPredictor(quantile=d["quantile"], window=d["window"])
        sched.predictor = p
        dpu = getattr(sched, "dpu", None)
        if dpu is not None and getattr(dpu, "predictor", None) is None:
            dpu.predictor = p
    p.quantile = d["quantile"]
    p.window = d["window"]
    p.observations = d["observations"]
    p._obs = {int(k): list(v) for k, v in d["obs"].items()}


def _snapshot_dpu(dpu) -> Optional[Dict]:
    if dpu is None:
        return None
    version, state, gauss = dpu._rng.getstate()
    return {"rng": [version, list(state), gauss],
            "iteration": dpu._iteration,
            "last_sampled": dict(dpu._last_sampled),
            "stats": dict(dpu.stats)}
    # _phase_memo is a pure memo keyed on _phase_version; it rebuilds on the
    # first refresh after restore and is deliberately not captured.


def _restore_dpu(dpu, d: Optional[Dict]) -> None:
    if dpu is None or d is None:
        return
    version, state, gauss = d["rng"]
    dpu._rng.setstate((version, tuple(state), gauss))
    dpu._iteration = d["iteration"]
    dpu._last_sampled = dict(d["last_sampled"])
    dpu.stats = dict(d["stats"])
    dpu._phase_memo = {}


def snapshot_scheduler(sched,
                       delivered: Optional[Dict[str, int]] = None) -> Dict:
    """Serialize the complete scheduler state: every relQuery with per-request
    progress (mid-chunk prefill, preemption restarts, swapped-out residents,
    cancellations), queue orders, ledger-relevant footprints, report counters,
    the output-length predictor's observation windows, and — for RelServe —
    the DPU's RNG/resample state. The snapshot is pure JSON (json.dumps-safe).

    The KV cache itself is deliberately NOT captured: token content is
    recomputable via prefill replay, and the prefix cache makes the replay
    cheap (DESIGN.md §6). ``delivered`` pins streamed-token high-water marks
    so a restoring replica knows what the Frontend already emitted."""
    return {
        "version": SNAPSHOT_VERSION,
        "iteration": sched.iteration,
        "counters": {k: getattr(sched, k) for k in _SCHED_COUNTERS
                     if hasattr(sched, k)},
        "relqueries": [snapshot_relquery(sched, rq, delivered)
                       for rq in sched.relqueries.values()],
        "waiting_order": {rel_id: [r.req_id for r in lst]
                          for rel_id, lst in sched._waiting_of.items()},
        "running_order": [r.req_id for r in sched._running],
        "swapped_order": [r.req_id for r in sched._swapped],
        "predictor": _snapshot_predictor(sched.predictor),
        "dpu": _snapshot_dpu(getattr(sched, "dpu", None)),
    }


def restore_scheduler(sched, snap: Dict, *, kv_lost: bool = True) -> Dict:
    """Rebuild a (fresh, empty) scheduler from a v2 snapshot.

    ``kv_lost=True`` — crash semantics: the device and host KV died with the
    replica, so every resident request (RUNNING, SWAPPED, or mid-chunk
    prefill) restarts preemption-style — generated tokens are preserved and
    recomputed by the next prefill pass, landed-but-unfinished chunks are
    dropped, and the ledgers rebuild to a zero-resident state.

    ``kv_lost=False`` — lossless round-trip: queue orders, states, mid-chunk
    progress, host-tier residency, and footprint charges restore exactly.
    Legitimate when the KV survives the scheduler object (the simulated
    executor derives KV purely from these ledgers; a live migration that
    moves KV pages would use this mode too).

    All ledgers are rebuilt through ``sched.audit_ledgers(repair=True)`` —
    the same audited derivation ``--debug-invariants`` checks per tick.
    Returns ``{"delivered": {req_id: streamed}, "requeued": n, ...}`` so the
    caller can seed Frontend dedup floors."""
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported scheduler snapshot version {snap.get('version')!r} "
            f"(want {SNAPSHOT_VERSION})")
    if sched.relqueries:
        raise ValueError("restore_scheduler requires an empty scheduler")
    sched.iteration = snap["iteration"]
    for k, v in snap.get("counters", {}).items():
        setattr(sched, k, v)

    delivered: Dict[str, int] = {}
    by_req: Dict[str, Request] = {}
    requeued = 0
    for q in snap["relqueries"]:
        reqs: List[Request] = []
        for rd in q["requests"]:
            r = Request(rel_id=q["rel_id"], tokens=tuple(rd["tokens"]),
                        max_output_tokens=rd["max_output_tokens"],
                        req_id=rd["req_id"], eos_token=rd["eos_token"])
            if rd.get("sim_output_len") is not None:
                r.sim_output_len = rd["sim_output_len"]
            r.state = RequestState(rd["state"])
            r.output_tokens = list(rd["output_tokens"])
            r.prefilled = rd["prefilled"]
            r.prefilled_tokens = rd["prefilled_tokens"]
            r.preserved_output_tokens = rd["preserved_output_tokens"]
            r.finish_time = rd["finish_time"]
            delivered[r.req_id] = rd.get("streamed", len(r.output_tokens))
            if r.state in (RequestState.RUNNING, RequestState.SWAPPED):
                if kv_lost:
                    r.preserved_output_tokens = len(r.output_tokens)
                    r.prefilled = False
                    r.prefilled_tokens = 0
                    r.state = RequestState.PREEMPTED
                    requeued += 1
                elif rd.get("footprint") is not None \
                        and r.state is RequestState.RUNNING:
                    sched._footprint_of[r.req_id] = rd["footprint"]
            elif r.state is RequestState.WAITING and r.prefilled_tokens:
                if kv_lost:
                    r.prefilled_tokens = 0   # landed chunks died with the KV
                elif rd.get("footprint") is not None:
                    sched._footprint_of[r.req_id] = rd["footprint"]
            by_req[r.req_id] = r
            reqs.append(r)
        rq = RelQuery(rel_id=q["rel_id"], requests=reqs,
                      arrival_time=q["arrival_time"],
                      max_output_tokens=q["max_output_tokens"],
                      template_id=q["template_id"])
        rq.first_prefill_start = q["first_prefill_start"]
        rq.last_prefill_end = q["last_prefill_end"]
        rq.finish_time = q["finish_time"]
        rq.cancel_time = q.get("cancel_time")
        rq.priority = q["priority"]
        rq.priority_fresh = q.get("priority_fresh", False)
        rq._was_all_waiting = q.get("was_all_waiting", False)
        rq.cache_miss_ratio = q.get("cache_miss_ratio", 1.0)
        rq.preemptions = q.get("preemptions", 0)
        sched.relqueries[rq.rel_id] = rq
        if rq.finish_time is not None and rq.cancel_time is None:
            sched.finished_relqueries.append(rq)

    # Queues rebuild in snapshot order. Under kv_lost the demoted residents
    # (running first, then swapped) go to the FRONT of their relQuery's
    # waiting list, mirroring what live preemption does.
    waiting_of = {rel_id: [by_req[i] for i in ids]
                  for rel_id, ids in snap["waiting_order"].items()}
    if kv_lost:
        demoted = [by_req[i] for i in
                   (*snap["running_order"], *snap["swapped_order"])]
        for r in reversed(demoted):
            waiting_of.setdefault(r.rel_id, []).insert(0, r)
    else:
        sched._running = [by_req[i] for i in snap["running_order"]]
        sched._swapped = [by_req[i] for i in snap["swapped_order"]]
    sched._waiting_of = {k: v for k, v in waiting_of.items() if v}
    sched._queue_version += 1
    sched.audit_ledgers(repair=True)

    _restore_predictor(sched, snap.get("predictor"))
    _restore_dpu(getattr(sched, "dpu", None), snap.get("dpu"))
    return {"delivered": delivered, "requeued": requeued,
            "relqueries": len(snap["relqueries"])}


# --------------------------------------------------------------------------
# in-process failover: rewind live relQuery objects
# --------------------------------------------------------------------------
def rewind_relquery_to_snapshot(rq: RelQuery, rq_snap: Dict) -> int:
    """Crash failover for the in-process Cluster: rewind a live relQuery to
    its last snapshot. Tokens generated after the snapshot died with the
    replica — the deterministic executor regenerates them bit-identically on
    the surviving replica, and Frontend high-water marks suppress re-emission
    of anything already streamed. Requests the snapshot saw as terminal keep
    their outcome. Returns the number of output tokens preserved."""
    by_id = {rd["req_id"]: rd for rd in rq_snap["requests"]}
    kept = 0
    for r in rq.requests:
        rd = by_id[r.req_id]
        if RequestState(rd["state"]) in (RequestState.FINISHED,
                                         RequestState.CANCELLED):
            continue   # outcome predates the snapshot: durable
        del r.output_tokens[len(rd["output_tokens"]):]
        r.state = RequestState.WAITING
        r.prefilled = False
        r.prefilled_tokens = 0
        r.preserved_output_tokens = 0
        r.finish_time = None
        kept += len(r.output_tokens)
    rq.finish_time = None
    rq.note_phase_change()
    return kept


def reset_relquery_for_recovery(rq: RelQuery) -> int:
    """From-scratch failover (no snapshot): everything the crashed replica
    generated for still-unfinished requests is lost and will be recomputed
    from the prompt. Returns the number of output tokens dropped."""
    lost = 0
    for r in rq.requests:
        if r.is_terminal():
            continue
        lost += len(r.output_tokens)
        r.output_tokens = []
        r.state = RequestState.WAITING
        r.prefilled = False
        r.prefilled_tokens = 0
        r.preserved_output_tokens = 0
        r.finish_time = None
    rq.finish_time = None
    rq.note_phase_change()
    return lost
