"""Meshes and the card's constants — the port of ``repro/launch/mesh.py``.

A mesh here is its shape, a dict of axis name to size, which is what the
sharding tables (``models.sharding``) read. ``make_production_mesh`` gives
the reference's TPU meshes (16 x 16 chips a pod, 2 pods): the dry run's
``--multi-pod`` / ``--both-meshes`` report the tables' per-device bytes on
them. ``make_host_mesh`` is the mesh of the visible CUDA devices: (1, 1) on
one H100. Nothing here touches the CUDA runtime at import.
"""
from __future__ import annotations

from typing import Dict


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model: int = 1, *, device="cuda") -> Dict[str, int]:
    """(data, model) over the visible CUDA devices, data = n / model; on
    the CPU (``device="cpu"``, or ``"meta"`` for a dry run) one device.
    Raises without a card unless the caller asks for the CPU or meta."""
    import torch

    from repro_torch.device import as_device, resolve_device

    dev = as_device(device)
    if dev.type == "meta":
        n = 1
    else:
        dev = resolve_device(dev)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return {"data": n // model, "model": model}


def mesh_shape_dict(mesh: Dict[str, int]) -> Dict[str, int]:
    return dict(mesh)


def mesh_name(mesh: Dict[str, int]) -> str:
    return "x".join(str(v) for v in mesh.values())


# NVIDIA H100 SXM5 80GB data sheet, dense rates: bf16 on the tensor cores;
# f32 on the CUDA cores (the port runs no TF32); HBM3 bandwidth; memory.
# The same values as chip_smoke.py's bounds and PERF.md's device layer.
PEAK_FLOPS_BF16 = 989e12       # per card
PEAK_FLOPS_F32 = 67e12         # per card, no tensor cores
HBM_BW = 3.35e12               # bytes/s per card
# NVLink 4 (900 GB/s a card, both directions): the collective term's rate
# on a mesh of several cards; one card has no collective, so it is unused
LINK_BW = 450e9                # bytes/s a card, one direction
HBM_PER_CHIP = 80 * 10**9      # 80 GB
