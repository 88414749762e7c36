"""Blocked f32 GEMMs for Hopper — the port of ``repro/kernels/matmul.py``.

Two wrappers, each with its plain PyTorch version beside it:

  * ``matmul`` replaces the Pallas ``matmul`` (``_mm_kernel``): (M,K)x(K,N)
    with an f32 accumulator. Consumers: ``LinearDirect`` and the patch GEMM
    of ``ConvIm2col``.
  * ``matmul_packed`` replaces the Pallas ``matmul_packed``
    (``_mm_packed_kernel``): it reads ``LinearPacked``'s (N/128, K/128,
    128, 128) layout in place, so each K step of a block loads rows of one
    contiguous 64 KB weight tile — the point of the packing transform.

Kernel: ``csrc/gemm_f32.cuh`` via ``csrc/matmul.cu`` (64x64 block tile, K
step 16, 4x4 outputs per thread, IEEE f32 FMA, no TF32; ragged M/N/K edges
masked in the kernel, nothing padded in device memory).

Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
max(2·M·N·K / 67e12, 4·(MK + KN + MN) / 3.35e12). The im2col GEMMs of
resnet50@224 — (12544,576)x(576,128) and (3136,1152)x(1152,256), 1.85
GFLOP each — are bound by operations (≈27.6 µs); the packed head
(1,256)x(256,100) is bound by launch latency. The design keeps the f32
FMA units fed from shared memory (two float4 shared loads per 16 FMAs) and
reads each A and B element from device memory once per block; raising
the tile and pipelining the loads is later work.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — there is no fallback. ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import _native

launches = {"matmul": 0, "matmul_packed": 0}
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------
def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32-accumulated x @ w, cast back to x's dtype (``matmul_ref``)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(x.shape)} x {tuple(w.shape)}")
    if _native.on_cpu("matmul", x, w):
        return matmul_plain(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        lib = _native.library("matmul")
        with torch.cuda.device(x.device):
            rc = lib.repro_matmul_f32(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(x.device).cuda_stream)
        _native.check(rc, "matmul")
        _count("matmul")
    return out


# ---------------------------------------------------------------------------
# matmul_packed
# ---------------------------------------------------------------------------
def matmul_packed_plain(x: torch.Tensor, w_packed: torch.Tensor,
                        K: int, N: int) -> torch.Tensor:
    """Blocked contraction over the packed layout, with the Pallas
    wrapper's padding: x's K is zero-padded to nK·bk, the result is cut to
    [:M, :N]."""
    nN, nK, bk, bn = w_packed.shape
    M = x.shape[0]
    Kp = nK * bk
    if x.shape[1] != Kp:
        x = F.pad(x, (0, Kp - x.shape[1]))
    xb = x.to(torch.float32).reshape(M, nK, bk)
    y = torch.einsum("mkc,nkcd->mnd", xb, w_packed.to(torch.float32))
    return y.reshape(M, nN * bn)[:, :N].to(x.dtype)


def matmul_packed(x: torch.Tensor, w_packed: torch.Tensor,
                  K: int, N: int) -> torch.Tensor:
    """x: (M, K); w_packed: (N/bn, K/bk, bk, bn) from LinearPacked."""
    if x.dim() != 2 or w_packed.dim() != 4:
        raise ValueError("matmul_packed: x must be (M, K) and w_packed 4-d")
    nN, nK, bk, bn = w_packed.shape
    if x.shape[1] != K or K > nK * bk or N > nN * bn:
        raise ValueError(f"matmul_packed: x {tuple(x.shape)} does not fit "
                         f"K={K}, N={N}, packed {tuple(w_packed.shape)}")
    if _native.on_cpu("matmul_packed", x, w_packed):
        return matmul_packed_plain(x, w_packed, K, N)
    if bk != 128 or bn != 128:
        raise ValueError("matmul_packed: the CUDA kernel takes 128x128 tiles")
    M = x.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        lib = _native.library("matmul")
        with torch.cuda.device(x.device):
            rc = lib.repro_matmul_packed_f32(
                x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), M, N, K,
                nK, torch.cuda.current_stream(x.device).cuda_stream)
        _native.check(rc, "matmul_packed")
        _count("matmul_packed")
    return out
