"""Winograd F(2x2,3x3) tile GEMM for Hopper — the port of
``repro/kernels/conv_winograd.py::winograd_tile_matmul`` (``_wino_mm_kernel``).

A 3x3/s1 conv becomes 16 independent (T, C)x(C, O) GEMMs over the
transformed 4x4 input tiles V (16, T, C) and the cached filter transform
U (16, C, O). The kernel is the shared f32 GEMM template
(``csrc/gemm_f32.cuh``) batched over the 16 positions on ``blockIdx.z``
(``csrc/conv_winograd.cu``): one launch, IEEE f32 FMA, no TF32, ragged T/C/O
edges masked in the kernel.

Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
max(2·16·T·C·O / 67e12, 4·16·(TC + CO + TO) / 3.35e12). At resnet50@224
the stage-0 GEMM (16, 12544, 64)x(16, 64, 64) moves 103 MB and is bound
by bytes (≈31 µs); stages 1 and 2 (C = O = 128, 256) are bound by
operations (≈24.5 µs each). With C = O = 64 every V element is read
once and used for 64 FMAs, so the kernel is limited by reading V; the
64x64 tile covers all of O in one block for the stage-0 shape, so V is
read from device memory exactly once there.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _native

launches = {"winograd_tile_matmul": 0}
_lock = threading.Lock()


def winograd_tile_matmul_plain(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """16 batched f32 GEMMs (``winograd_tile_matmul_ref``)."""
    return torch.einsum("ktc,kco->kto", V.to(torch.float32),
                        U.to(torch.float32)).to(V.dtype)


def winograd_tile_matmul(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    if V.dim() != 3 or U.dim() != 3 or V.shape[0] != U.shape[0] \
            or V.shape[2] != U.shape[1]:
        raise ValueError(f"winograd_tile_matmul: bad shapes {tuple(V.shape)} "
                         f"x {tuple(U.shape)}")
    if _native.on_cpu("winograd_tile_matmul", V, U):
        return winograd_tile_matmul_plain(V, U)
    P, T, C = V.shape
    O = U.shape[2]
    out = torch.empty((P, T, O), dtype=torch.float32, device=V.device)
    if P and T and O:
        lib = _native.library("conv_winograd")
        with torch.cuda.device(V.device):
            rc = lib.repro_winograd_tile_matmul_f32(
                V.data_ptr(), U.data_ptr(), out.data_ptr(), P, T, C, O,
                torch.cuda.current_stream(V.device).cuda_stream)
        _native.check(rc, "winograd_tile_matmul")
        with _lock:
            launches["winograd_tile_matmul"] += 1
    return out
