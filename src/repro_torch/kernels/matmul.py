"""Blocked GEMMs for Hopper — the port of ``repro/kernels/matmul.py``.

Two wrappers, each with its plain PyTorch version beside it:

  * ``matmul`` replaces the Pallas ``matmul`` (``_mm_kernel``): (M,K)x(K,N)
    with an f32 accumulator, in f32 (f32 out), in bf16 (bf16 out, each
    output rounded once) or bf16 in with f32 out (``out_dtype=float32``:
    the accumulator stored as it is, ``jnp.dot(bf16, bf16,
    preferred_element_type=f32)``). Consumers: ``LinearDirect`` and the
    patch GEMM of ``ConvIm2col`` in f32; the seven projections of every
    decoder block and the LM head of the cold-LLM graph in bf16
    (``models.layers``, ``core.llm_graph``); ``LinearLowPrecision`` with
    f32 out.
  * ``matmul_packed`` replaces the Pallas ``matmul_packed``
    (``_mm_packed_kernel``): it reads ``LinearPacked``'s (N/128, K/128,
    128, 128) layout in place, so each K step of a block loads rows of one
    contiguous 64 KB weight tile — the point of the packing transform.

Kernel: ``csrc/gemm_f32.cuh`` via ``csrc/matmul.cu`` (64x64 block tile, K
step 16, 4x4 outputs per thread, IEEE f32 FMA, no TF32; ragged M/N/K edges
masked in the kernel, nothing padded in device memory). The bf16 entry
converts on load and rounds on store (or, with f32 out, stores the
accumulator as it is); its products stay on the CUDA cores (``wgmma`` is
later work).

Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
max(2·M·N·K / 67e12, 4·(MK + KN + MN) / 3.35e12). The im2col GEMMs of
resnet50@224 — (12544,576)x(576,128) and (3136,1152)x(1152,256), 1.85
GFLOP each — are bound by operations (≈27.6 µs); the packed head
(1,256)x(256,100) is bound by launch latency. The design keeps the f32
FMA units fed from shared memory (two float4 shared loads per 16 FMAs) and
reads each A and B element from device memory once per block; raising
the tile and pipelining the loads is later work. The bf16 GEMMs of the
smollm-360m prefill (M = 64 tokens) are bound by reading the weights at
3.35 TB/s (the head, (64,960)x(960,49152), moves 101 MB: 30 µs) or by
launch latency; with M = 64 the 64x64 tile gives only N/64 blocks (15 for
the d_model projections), so this kernel leaves most SMs idle there.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — there is no fallback. ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _native

launches = {"matmul": 0, "matmul_bf16": 0, "matmul_packed": 0}
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------
def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """f32-accumulated x @ w, cast to ``out_dtype`` (default x's dtype;
    ``matmul_ref``)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(
        out_dtype or x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) (float32 or bfloat16; w the same) in
    ``out_dtype``: x's dtype by default, or float32 for bf16 inputs."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(x.shape)} x {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"matmul: no {out_dtype} output for {x.dtype} inputs")
    if _native.on_cpu("matmul", x, w,
                      dtypes=(torch.float32, torch.bfloat16)):
        return matmul_plain(x, w, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M and N:
        lib = _native.library("matmul")
        bf16 = x.dtype == torch.bfloat16
        fn = ((lib.repro_matmul_bf16_f32out if out_dtype == torch.float32
               else lib.repro_matmul_bf16) if bf16 else lib.repro_matmul_f32)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                    torch.cuda.current_stream(x.device).cuda_stream)
        _native.check(rc, "matmul")
        _count("matmul_bf16" if bf16 else "matmul")
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
