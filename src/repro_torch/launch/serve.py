"""Serving launcher: batched greedy decode over a reduced model — the port
of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b

The reduced config of ``--arch`` (``ArchConfig.reduced``, as the reference
serves it) gets the port's own random weights from seed 0 and a
``BatchedServer`` with ``--max-batch`` slots; ``--requests`` prompts of
``--prompt-len`` random tokens (numpy seed 0) each decode ``--new-tokens``
tokens. It runs on the card unless ``--device cpu`` is given. Every
token model is served (the dense, moe, ssm and hybrid families); an
``embeddings`` or ``vlm`` configuration (musicgen-medium, internvl2-76b)
exits, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import BatchedServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS, default="smollm-360m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.input_mode != "tokens":
        raise SystemExit("serve demo targets token models")
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    srv = BatchedServer(params, cfg, max_batch=args.max_batch, max_len=256,
                        device=dev)
    print(f"server up in {time.perf_counter() - t0:.2f}s "
          f"(arch={cfg.name}, slots={args.max_batch}, device={dev})")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    for r in reqs:
        print(f"req {r.rid}: ttft {r.first_token_s:.3f}s "
              f"done {r.done_s:.3f}s tokens {r.out_tokens[:6]}...")
    return reqs


if __name__ == "__main__":
    main()
