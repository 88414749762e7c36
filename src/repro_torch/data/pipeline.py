"""Deterministic synthetic token and embedding streams in the microbatched
layout the train step expects — the port of ``repro/data/pipeline.py``.

``batch_at(step)`` draws from ``np.random.default_rng(seed * 1_000_003 +
step)`` exactly as the reference does, so both packages see the same
bytes: tokens and labels int32, embeddings f32 rounded once to the config
dtype (round to nearest even, as ``jnp.asarray`` rounds). The tensors go
onto ``device`` (the card by default; raises without one).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


def make_batch_shape(cfg: ArchConfig, batch: int, seq: int,
                     microbatches: int = 1) -> Dict[str, tuple]:
    """Each batch key's shape: (microbatches, batch / microbatches, ...)
    when ``microbatches`` > 1, else (batch, ...)."""
    def lead(*dims):
        if microbatches > 1:
            return (microbatches, batch // microbatches, *dims)
        return (batch, *dims)

    if cfg.input_mode == "tokens":
        return {"tokens": lead(seq)}
    if cfg.input_mode == "embeddings":
        return {"embeds": lead(seq, cfg.d_model), "labels": lead(seq)}
    return {"tokens": lead(seq - cfg.num_prefix_embeds),
            "prefix_embeds": lead(cfg.num_prefix_embeds, cfg.d_model)}


class SyntheticPipeline:
    """Deterministic per-step batches (seeded) on ``device``."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 microbatches: int = 1, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.microbatches = microbatches
        self.seed = seed
        self.device = resolve_device(device)
        self._shapes = make_batch_shape(cfg, batch, seq, microbatches)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        out = {}
        for k, shape in self._shapes.items():
            if k in ("tokens", "labels"):
                a = rng.integers(0, self.cfg.vocab_size, size=shape,
                                 dtype=np.int32)
                out[k] = torch.from_numpy(a).to(self.device)
            else:
                a = rng.standard_normal(shape).astype(np.float32)
                out[k] = torch.from_numpy(a).to(
                    self.device, getattr(torch, self.cfg.dtype))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
