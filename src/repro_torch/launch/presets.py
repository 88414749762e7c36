"""Per-(arch × shape) execution presets used by the launchers and the dry
run — the port of ``repro/launch/presets.py``, the same tables.

``TRAIN_MICROBATCHES`` was sized in the reference so each arch's train_4k
live activations fit 16 GiB a TPU chip on the 16 x 16 mesh (with
scan+remat the dominant saved tensor is the per-layer residual stream, L ×
(B/data/micro) × S × d × 2 bytes). The dry run keeps them as the
reference's presets and reports what they give on one 80 GB card.
"""
from __future__ import annotations

TRAIN_MICROBATCHES = {
    # archs whose head counts don't divide the 16-way model axis (smollm 15H,
    # granite 24H/8KV, musicgen 24H) keep attention replicated over `model`,
    # so their microbatches are sized for per-device B_local=1 at 4k.
    "smollm-360m": 16,
    "granite-moe-3b-a800m": 16,
    "qwen3-moe-30b-a3b": 8,
    "mamba2-2.7b": 8,
    "zamba2-2.7b": 8,
    "musicgen-medium": 16,
    "mistral-nemo-12b": 16,
    "gemma2-27b": 16,
    "internvl2-76b": 32,
    "qwen3-32b": 16,
}

# hierarchical remat: checkpoint groups of N layers (saved residual stack is
# L/N deep; one extra inner forward in backward). Only where activation
# memory is the binding constraint.
TRAIN_REMAT_GROUP = {
    "internvl2-76b": 4,
}

# archs whose long_500k run uses the sliding-window variant
NEEDS_SW_FOR_LONG = {
    "smollm-360m",
    "granite-moe-3b-a800m",
    "qwen3-moe-30b-a3b",
    "musicgen-medium",
    "mistral-nemo-12b",
    "internvl2-76b",
    "qwen3-32b",
    # zamba2's shared block attends globally (cache seq-sharded); mamba2 and
    # gemma2 are natively sub-quadratic / windowed.
}


def config_for(arch: str, shape_name: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if shape_name == "long_500k" and arch in NEEDS_SW_FOR_LONG:
        cfg = cfg.with_sliding_window(4096)
    return cfg
