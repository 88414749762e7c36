"""Roofline terms of a counted step — the port of
``repro/roofline/analysis.py``.

The reference derives its terms from a compiled TPU program's HLO
(``hlo_cost``); the port counts the step's own ops and kernels as they run
(``roofline.op_cost``), on meta tensors for a dry run or on the card:

  compute    = FLOPs per device / peak FLOP/s
  memory     = HBM bytes per device / HBM bandwidth
  collective = wire bytes per device / link bandwidth

On one card there are no collectives: ``wire_bytes_per_device``,
``collective_s`` and ``collective_by_kind`` are 0. ``flashable_hbm_bytes``
is the traffic the reference's jnp attention leaves in HBM that its Pallas
flash kernel would keep on chip; the port's attention already runs on its
flash kernel, whose counted bytes are q, k, v and o only, so it is 0 and
``memory_s_flash`` equals ``memory_s``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6 (train) or 2 × N_active × tokens
    useful_flops_ratio: float     # model_flops / (flops_per_device * chips)
    peak_memory_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    # traffic the flash kernel keeps on chip: 0 in the port (docstring)
    flashable_hbm_bytes: float = 0.0
    memory_s_flash: float = 0.0

    def to_dict(self):
        return asdict(self)


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    flops: float,
    hbm_bytes: float,
    model_flops: float,
    peak_flops: float,
    hbm_bw: float,
    peak_memory_bytes: float = 0.0,
) -> RooflineReport:
    """The report from a count's per-device totals (``op_cost.OpCost``'s
    ``flops`` and ``hbm_bytes``) on one card: no wire bytes, so the
    collective term is 0."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    bottleneck = max(terms, key=terms.get)
    total_hw_flops = flops * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm_bytes,
        wire_bytes_per_device=0.0,
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total_hw_flops
                            if total_hw_flops else 0.0),
        peak_memory_bytes=peak_memory_bytes,
        collective_by_kind={},
        flashable_hbm_bytes=0.0,
        memory_s_flash=memory_s,
    )
