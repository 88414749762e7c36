"""Stand-ins for every model input, the params and the decode state, as
tensors on the ``meta`` device (shape and dtype, no data) — the port of
``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s they replace. The
dry run (``launch.dryrun``) runs its steps on them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                microbatches: int = 1) -> dict:
    """Batch tree for one step of the given kind (train/prefill/decode).

    For training with microbatches > 1 the leaves get a leading
    (microbatches, B/microbatches, ...) layout — see train/step.py.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        def lead(*dims, dtype):
            if microbatches > 1:
                assert B % microbatches == 0, (B, microbatches)
                return _meta((microbatches, B // microbatches, *dims), dtype)
            return _meta((B, *dims), dtype)

        if cfg.input_mode == "tokens":
            return {"tokens": lead(S, dtype=torch.int32)}
        if cfg.input_mode == "embeddings":
            return {
                "embeds": lead(S, cfg.d_model, dtype=dt),
                "labels": lead(S, dtype=torch.int32),
            }
        if cfg.input_mode == "vlm":
            P = cfg.num_prefix_embeds
            return {
                "tokens": lead(S - P, dtype=torch.int32),
                "prefix_embeds": lead(P, cfg.d_model, dtype=dt),
            }
        raise ValueError(cfg.input_mode)
    # decode: one new token against a seq_len-deep cache
    if cfg.input_mode == "embeddings":
        return {"embeds": _meta((B, 1, cfg.d_model), dt)}
    return {"tokens": _meta((B, 1), torch.int32)}


def params_shape(cfg: ArchConfig):
    """``init_params``' tree on meta: built from shapes, nothing drawn."""
    from repro_torch.models import transformer as T

    return T.init_params(cfg, torch.Generator(), device=META)


def decode_state_shape(cfg: ArchConfig, batch: int, context_len: int):
    from repro_torch.models import transformer as T

    return T.init_decode_state(cfg, batch, context_len, device=META)
