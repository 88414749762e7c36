"""Public kernel entry points of the port — the counterpart of
``repro/kernels/ops.py``.

Dispatch is by the tensors' device: a CUDA tensor launches the
hand-written Hopper kernel (``repro_torch/csrc``), a CPU tensor takes the
kernel's plain PyTorch version (the analogue of Pallas ``interpret=True``
in the JAX package). The registry kernels' ``execute`` bodies call these.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import conv_winograd as _wino
from repro_torch.kernels import matmul as _mm

matmul = _mm.matmul
matmul_packed = _mm.matmul_packed
winograd_tile_matmul = _wino.winograd_tile_matmul

# name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "matmul": ("src/repro_torch/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:37"),
    "matmul_packed": ("src/repro_torch/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:81"),
    "winograd_tile_matmul": ("src/repro_torch/csrc/conv_winograd.cu",
                             "src/repro/kernels/conv_winograd.py:39"),
}

_COUNTERS = (_mm.launches, _wino.launches)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
