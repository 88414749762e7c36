"""Config registry: ``get_config(arch_id)`` for every assigned architecture.

The port's own copy of the JAX package's configs (plain dataclasses). Class
and field names stay as they are: a tblock's ``LayerSpec.config`` holds
``{"cfg": cfg}`` and the shape-class keys hash ``type(cfg).__name__`` and
``asdict(cfg)``, so ProfileDB entries read across the two packages.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig, INPUT_SHAPES  # noqa: F401

# arch-id (dashed, as used on CLI) -> module name
_ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "smollm-360m": "smollm_360m",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "musicgen-medium": "musicgen_medium",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma2-27b": "gemma2_27b",
    "internvl2-76b": "internvl2_76b",
    "qwen3-32b": "qwen3_32b",
}

# the paper's own evaluation models (CNN chains for the cold engine) are in
# repro_torch.configs.cnn_zoo / repro_torch.models.cnn — built via
# build_cnn(name), not ArchConfig (they are host-scale engine graphs, not distributed decoders)
PAPER_CNNS = ["resnet18", "resnet50", "mobilenet", "squeezenet", "alexnet"]

ASSIGNED_ARCHS = [
    "zamba2-2.7b",
    "granite-moe-3b-a800m",
    "smollm-360m",
    "mamba2-2.7b",
    "qwen3-moe-30b-a3b",
    "musicgen-medium",
    "mistral-nemo-12b",
    "gemma2-27b",
    "internvl2-76b",
    "qwen3-32b",
]


def get_config(arch: str) -> ArchConfig:
    if arch.endswith("-reduced"):
        return get_config(arch[: -len("-reduced")]).reduced()
    try:
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ASSIGNED_ARCHS)
