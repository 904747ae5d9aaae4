"""End-to-end training entry point of the port, the PyTorch counterpart of
``repro/launch/train.py``, on one device (CUDA unless ``--device cpu``).

Trains an --arch model (smoke config by default; --layers/--d-model override)
on synthetic relational text, with checkpoint/restart via
repro_torch.distributed.fault_tolerance — kill it mid-run and rerun with the
same --ckpt-dir to resume. The checkpoints are the reference's format.
On CUDA the step is captured once as a CUDA graph and replayed
(``training/train_step.py::TrainStep``, the counterpart of the reference's
jitted step); on the CPU it runs eagerly.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.datasets import make_dataset
from repro_torch.distributed.fault_tolerance import (latest_step, load_checkpoint,
                                                     save_checkpoint)
from repro_torch.engine.tokenizer import HashTokenizer
from repro_torch.models.registry import build_model
from repro_torch.serving.factory import resolve_device
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import TrainConfig, TrainStep


def token_stream(dataset, tokenizer, batch: int, seq: int, seed: int):
    """Pack rendered relational rows into fixed-length LM batches."""
    rng = np.random.RandomState(seed)
    buf = []
    while True:
        tpl = dataset.templates[rng.randint(len(dataset.templates))]
        row = dataset.table.rows[rng.randint(len(dataset.table))]
        buf.extend(tokenizer.encode(tpl.render(row)))
        if len(buf) >= batch * (seq + 1):
            arr = np.asarray(buf[: batch * (seq + 1)], np.int32).reshape(batch, seq + 1)
            buf = buf[batch * (seq + 1):]
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))

    cfg = get_smoke_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M")

    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    opt = init_opt_state(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start, trees = load_checkpoint(
            args.ckpt_dir, template_trees={"params": params, "opt": opt})
        params, opt = trees["params"], trees["opt"]
        print(f"resumed from step {start}")

    tc = TrainConfig(grad_accum=args.grad_accum, adamw=AdamWConfig(lr=args.lr))
    step_fn = TrainStep(model, tc, params, opt)
    ds = make_dataset("rotten", num_rows=2000, seed=args.seed)
    tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
    stream = token_stream(ds, tok, args.batch, args.seq, args.seed + start)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(stream)
        metrics = step_fn(batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, step_fn.trees,
                            {"arch": cfg.name})
            print(f"  checkpointed step {step + 1}")


if __name__ == "__main__":
    main()
