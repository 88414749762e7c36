"""AdamW with global-norm clipping and a cosine schedule — the port of
``repro/optim/adamw.py``.

Moments are f32 whatever the parameter's dtype; the update runs in f32 in
the reference's order — the clip scale min(1, clip / max(|g|, 1e-9)), the
moments, the bias corrections, ``mh / (sqrt(vh) + eps) + wd · p`` — and is
cast back to the parameter's dtype, so bf16 training stays stable.
``torch.optim.AdamW`` is not its twin: it decays the weights before the
step and in the parameter's dtype. Plain tensor ops: the reference runs
this in XLA, not in a Pallas kernel. Trees are walked in JAX's leaf order
(``repro_torch.pytree``), so the global norm sums its leaves in the
reference's order.

``adamw_update`` is functional (new params and moments; the step counter
an int32 0-d tensor); ``train.make_train_step`` copies the new params into
the leaf tensors in place. ``from_reference`` carries a JAX ``AdamWState``
(numpy leaves) across with the weights.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.pytree import leaves, tree_map, unflatten

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any
    v: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    dev = leaves(params)[0].device if leaves(params) else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def from_reference(state: Any) -> AdamWState:
    """A JAX ``AdamWState`` (numpy or jax leaves) as the port's, on the
    CPU, with the same values."""
    def conv(a):
        return bf16.to_tensor(np.array(a))

    return AdamWState(step=conv(state.step), m=tree_map(conv, state.m),
                      v=tree_map(conv, state.v))


def cosine_lr(base_lr: float, warmup: int,
              total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine to
    0 at ``total``: a function of the step (a tensor) giving an f32
    0-d tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}), the
    reference's arithmetic in f32; ``lr`` a float or a schedule of the
    new step."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr_t = (lr(step) if callable(lr)
            else torch.tensor(lr, dtype=F32, device=gnorm.device))
    stepf = step.to(F32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(F32)
        return (p.to(F32) - lr_t * delta).to(p.dtype), m, v

    cols = [leaves(t) for t in (params, grads, state.m, state.v)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("adamw_update: params, grads and moments differ in "
                         "structure")
    outs = [upd(*xs) for xs in zip(*cols)]
    return (unflatten(params, [o[0] for o in outs]),
            AdamWState(step=step, m=unflatten(state.m, [o[1] for o in outs]),
                       v=unflatten(state.v, [o[2] for o in outs])),
            {"grad_norm": gnorm, "lr": lr_t})
