"""Training launcher — the port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 --batch 8 --seq 512 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 5 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 10 --batch 8 --seq 512 \\
      --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --steps 10 --batch 8 --seq 512 --microbatches 2

``--arch`` at full width (or ``--reduced``, with ``--d-model`` and
``--layers`` overrides as in the reference) gets the port's own random
weights from ``--seed``, trains on ``data.SyntheticPipeline`` batches with
``train.make_train_step`` (remat on, the reference's warmup of min(100,
steps / 10 + 1)), prints loss, grad norm and tokens/s, and writes
checkpoints with ``checkpoint.save_pytree`` every ``--ckpt-every`` steps.
Every family trains: the dense body (the dense, vlm and audio families),
moe, and ssm and hybrid (``ssd_scan``'s backward kernel, remat a mamba
block or a hybrid group a checkpoint); ``--seq`` must be a multiple of
an SSM config's chunk (256 at full width, 32 reduced). It runs on the
card unless ``--device cpu`` is given, and raises without one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS, default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced d_model (e.g. ~100M scale)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        d_ff=args.d_model * 4 if cfg.d_ff else 0,
                        num_heads=max(1, args.d_model // 64) if cfg.num_heads else 0,
                        num_kv_heads=max(1, args.d_model // 128) if cfg.num_kv_heads else 0)
        if args.layers:
            over["num_layers"] = args.layers
        cfg = cfg.reduced(**over)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"active≈{cfg.active_param_count()/1e6:.1f}M device={dev}")

    params = T.init_params(cfg,
                           torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    step = make_train_step(
        cfg, lr=args.lr, warmup=min(100, args.steps // 10 + 1),
        total_steps=args.steps, num_microbatches=args.microbatches,
        remat=True)
    pipe = SyntheticPipeline(cfg, args.batch, args.seq,
                             microbatches=args.microbatches, seed=args.seed,
                             device=dev)
    t0 = time.perf_counter()
    tokens_per_step = args.batch * args.seq
    for i in range(args.steps):
        params, opt, m = step(params, opt, pipe.batch_at(i))
        if i % max(1, args.steps // 20) == 0 or i == args.steps - 1:
            loss = float(m["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"tok/s {tokens_per_step * (i + 1) / dt:,.0f}")
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            save_pytree(Path(args.ckpt_dir) / f"step_{i + 1}", params)
            print(f"  checkpoint -> {args.ckpt_dir}/step_{i + 1}")
    print(f"done in {time.perf_counter() - t0:.1f}s; final loss "
          f"{float(m['loss']):.4f}")
    return float(m["loss"])


if __name__ == "__main__":
    main()
