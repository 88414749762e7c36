"""Winograd F(2x2,3x3) tile GEMM for Hopper — the port of
``repro/kernels/conv_winograd.py::winograd_tile_matmul`` (``_wino_mm_kernel``).

A 3x3/s1 conv becomes 16 independent (T, C)x(C, O) GEMMs over the
transformed 4x4 input tiles V (16, T, C) and the cached filter transform
U (16, C, O). The kernel is the f32 path template
(``csrc/gemm_f32_paths.cuh``) batched over the 16 positions
(``csrc/conv_winograd.cu``): one launch, IEEE f32 FMA with each output's
FMAs in k order, no TF32, no atomics, ragged T/C/O edges masked in the
kernel, along the path ``plan_f32_gemm(T, O, C, batch=16)`` picks from the
shapes alone:
  * ``stream`` where C <= 64 (resnet50's stem, C = 3, and stage 0, C =
    64): persistent blocks, two an SM, walk contiguous runs of (position,
    128-row tile) items; the next item's rows of V are copied (``cp.async``)
    while the current item's FMAs run, U[p]'s slab stays in shared memory
    while consecutive items share p, and outputs are stored 16 bytes at a
    time. With O <= 64 each V element is read from device memory once;
  * ``tile`` otherwise (stages 1 and 2, C = 128, 256): the batched block
    tile path over 16 x tiles, with the planner's tile and K split.

Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
max(2·16·T·C·O / 67e12, 4·16·(TC + CO + TO) / 3.35e12). At resnet50@224
the stage-0 GEMM (16, 12544, 64)x(16, 64, 64) moves 103 MB and is bound
by bytes (≈31 µs; its 1.64 GFLOP take ≈24.5 µs at the f32 peak, so the
FMAs must overlap the copies); the stem by writing its output (≈16 µs);
stages 1 and 2 (C = O = 128, 256) by operations (≈24.5 µs each).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches only
(a split plan's sum kernel included in its one).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _native
from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

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
        plan = plan_f32_gemm(T, O, C, False, P)
        scratch = (torch.empty(plan.split * P * T * O, dtype=torch.float32,
                               device=V.device)
                   if plan.split > 1 else None)
        lib = _native.library("conv_winograd")
        with _native.on_device(V.device):
            rc = lib.repro_winograd_tile_matmul_f32(
                V.data_ptr(), U.data_ptr(), out.data_ptr(), P, T, C, O,
                _PATH_CODE[plan.path], plan.bm, plan.bn, plan.split,
                plan.blocks, None if scratch is None else scratch.data_ptr(),
                _native.current_stream(V.device))
        _native.check(rc, "winograd_tile_matmul")
        with _lock:
            launches["winograd_tile_matmul"] += 1
    return out
