"""Training step: gradient accumulation over microbatches and AdamW — the
port of ``repro/train/step.py``.

``num_microbatches`` > 1 takes the batch in the (n, B/n, ...) layout that
``data.SyntheticPipeline`` delivers and runs forward and backward one
microbatch at a time, so live activation memory is 1/n of the full
batch's. Gradients are cast to f32 and, with microbatches, summed in f32
in microbatch order from zero and divided by n (the reference's scan);
the metrics are the microbatches' mean. Gradients come from
``torch.autograd.grad`` through the ``matmul`` and ``flash_attention``
kernels' backward, the MoE layer's (``gmm_blocks``, ``gmm_blocks_dw``)
and ``ssd_scan``'s (``ssd_scan_bwd``) on CUDA tensors, or their plain
versions on CPU tensors; nothing here depends on the family.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_update, cosine_lr
from repro_torch.pytree import leaves, unflatten

F32 = torch.float32


def step_grads(params: Any, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
               *, num_microbatches: int = 1, remat: bool = True,
               remat_group: int = 1
               ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """One step's f32 gradients (a list in ``pytree.leaves(params)``'s
    order) and metrics: ``loss_fn``'s gradient through
    ``torch.autograd.grad`` (params must require grad), with microbatches
    summed in f32 from zero in microbatch order and divided by n, the
    metrics their mean (detached)."""
    ps = leaves(params)

    def one(mb):
        total, metrics = T.loss_fn(params, mb, cfg, remat=remat,
                                   remat_group=remat_group)
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        return ([torch.zeros(p.shape, dtype=F32, device=p.device)
                 if g is None else g.to(F32) for p, g in zip(ps, gs)],
                {k: v.detach() for k, v in metrics.items()})

    if num_microbatches == 1:
        return one(batch)
    n = num_microbatches
    grads = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in ps]
    ms = []
    for i in range(n):
        g, m = one({k: v[i] for k, v in batch.items()})
        grads = [a + b for a, b in zip(grads, g)]
        ms.append(m)
    return ([g / n for g in grads],
            {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, num_microbatches: int = 1,
                    remat: bool = True, remat_group: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` are leaf tensors (``requires_grad`` is set on
    any that lack it) and are updated IN PLACE: the returned params are the
    same tensors holding the new values (AdamW's f32 update cast to their
    dtype). ``opt_state`` is returned new. ``metrics``: "loss",
    "aux_loss", "grad_norm", "lr" as 0-d tensors on the params' device (no
    host sync)."""
    schedule = cosine_lr(lr, warmup, total_steps)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        grads, metrics = step_grads(params, batch, cfg,
                                    num_microbatches=num_microbatches,
                                    remat=remat, remat_group=remat_group)
        new, opt_state, opt_metrics = adamw_update(
            unflatten(params, grads), opt_state, params, lr=schedule)
        with torch.no_grad():
            for p, q in zip(ps, leaves(new)):
                p.copy_(q)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
