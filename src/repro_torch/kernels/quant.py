"""Dequantization kernels for the quantized transform cache — the port of
``repro/kernels/quant.py``.

Four wrappers, each with its plain PyTorch version beside it:

  * ``dequant_int8`` / ``dequant_int4`` replace the Pallas ``dequant_int8``
    (``_dq8_kernel``) and ``dequant_int4`` (``_dq4_kernel``): expand a
    per-channel int8 tensor (K, N), or its nibble-packed int4 form
    ((K+1)//2, N) uint8 (row 2i in the low nibble, 2i+1 in the high one,
    sign-extended), to f32 as ``q · scale``. One f32 multiply of exact
    values per element: the kernel equals the plain version bit for bit.
    Consumer: ``core.llm_graph._dequant`` (``TBlockInt8/Int4``,
    ``HeadInt8/Int4``), which then runs the bf16 block forward.
  * ``matmul_dequant_int8`` / ``matmul_dequant_int4`` replace the Pallas
    ``matmul_dequant_int8`` (``_mm_dq8_kernel``) and
    ``matmul_dequant_int4`` (``_mm_dq4_kernel``): ``(x @ q) · scale``, the
    per-output-channel scale applied once to the finished f32 accumulator.
    x is f32 or bf16 and the result is in x's type. Consumers:
    ``LinearInt8`` / ``LinearInt4`` (the CNN graphs' linear head).

Kernels: ``csrc/quant.cu``. The dequant kernels are bound by bytes (read
1 B or 0.5 B, write 4 B a weight; at the LM head (960, 49152) of
smollm-360m that is 70 µs at 3.35 TB/s): 4 columns a thread, one 4-byte
load and one float4 store a row, the thread's scales loaded once for the
rows it walks. The fused kernels read device memory at the quantized
byte count and convert the weights to f32 on chip (exact); x is not
padded (the Pallas wrapper pads x to 2·rows for int4; here its columns
>= K are masked). Both run on the f32 path template
(``csrc/gemm_f32_paths.cuh``) along ``plan_f32_gemm(M, N, K)``: on the
skinny path (M <= 16, the resnet50 head, decode) each thread streams 16,
4 or 1 bytes of a row (``q_loader``: 16, 4 or 1 int8 columns, or packed
columns of two int4 rows) and sign-extends them in registers; on the
tile path a K step's byte rows (32 int8 or 16 packed int4 rows, a
quarter or an eighth of an f32 stage) are copied into shared memory and
widened once a K step for the whole block; the scale multiplies the
finished sum once, in the store or in the kernel that sums a split's
partials.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — there is no fallback. The wrappers mix
integer, f32 and bf16 tensors, so each names a dtype set per argument
(``_native.on_cpu(..., each=...)``) and checks its shapes itself.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.kernels import _native
from repro_torch.kernels.matmul import launch_f32, plan_f32_gemm

launches = {"dequant_int8": 0, "dequant_int4": 0,
            "matmul_dequant_int8": 0, "matmul_dequant_int4": 0}
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


def _check_scale(kernel: str, scale: torch.Tensor, N: int) -> None:
    if scale.numel() != N or (scale.dim() == 2 and scale.shape[0] != 1):
        raise ValueError(f"{kernel}: scale {tuple(scale.shape)} is not "
                         f"(1, {N})")


def _check_packed(kernel: str, packed: torch.Tensor, K: int) -> None:
    if packed.dim() != 2 or packed.shape[0] != (K + 1) // 2:
        raise ValueError(f"{kernel}: packed {tuple(packed.shape)} does not "
                         f"hold K={K} rows")


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with _native.on_device(device):
        rc = fn(*args, _native.current_stream(device))
    _native.check(rc, name)
    _count(name)


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' order of operations)
# ---------------------------------------------------------------------------
def unpack_int4_plain(packed: torch.Tensor, K: int) -> torch.Tensor:
    """((K+1)//2, N) uint8 nibbles -> (K, N) sign-extended int8 values."""
    p = packed.to(torch.int16)
    lo, hi = p & 0x0F, (p >> 4) & 0x0F
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    full = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])
    return full[:K].to(torch.int8)


def dequant_int8_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)


def dequant_int4_plain(packed: torch.Tensor, scale: torch.Tensor,
                       K: int) -> torch.Tensor:
    return dequant_int8_plain(unpack_int4_plain(packed, K), scale)


def matmul_dequant_int8_plain(x: torch.Tensor, q: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """(x @ q) · scale in f32, scale after the contraction, cast to x's
    dtype."""
    y = torch.matmul(x.to(torch.float32), q.to(torch.float32))
    return (y * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def matmul_dequant_int4_plain(x: torch.Tensor, packed: torch.Tensor,
                              scale: torch.Tensor, K: int) -> torch.Tensor:
    return matmul_dequant_int8_plain(x, unpack_int4_plain(packed, K), scale)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
_F32 = (torch.float32,)
_X = (torch.float32, torch.bfloat16)


def dequant_int8_cost(out, q, scale) -> Tuple[float, float]:
    """One multiply an element; q and the scales read, f32 written."""
    K, N = q.shape
    return K * N, K * N + 4 * N + 4 * K * N


def dequant_int4_cost(out, packed, scale, K) -> Tuple[float, float]:
    """One multiply an element; the packed nibbles and the scales read,
    f32 written."""
    N = packed.shape[1]
    return K * N, packed.shape[0] * N + 4 * N + 4 * K * N


@_native.costed("dequant_int8", dequant_int8_cost)
def dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 + (1, N) f32 scale -> (K, N) f32."""
    if q.dim() != 2:
        raise ValueError(f"dequant_int8: q must be (K, N), got {tuple(q.shape)}")
    K, N = q.shape
    _check_scale("dequant_int8", scale, N)
    if _native.on_cpu("dequant_int8", q, scale, each=((torch.int8,), _F32),
                      meta=True):
        return dequant_int8_plain(q, scale)
    out = torch.empty((K, N), dtype=torch.float32, device=q.device)
    if K and N and not q.is_meta:
        lib = _native.library("quant")
        _launch("dequant_int8", lib.repro_dequant_int8, q.data_ptr(),
                scale.data_ptr(), out.data_ptr(), K, N, device=q.device)
    return out


@_native.costed("dequant_int4", dequant_int4_cost)
def dequant_int4(packed: torch.Tensor, scale: torch.Tensor,
                 K: int) -> torch.Tensor:
    """((K+1)//2, N) packed uint8 + (1, N) f32 scale -> (K, N) f32."""
    _check_packed("dequant_int4", packed, K)
    N = packed.shape[1]
    _check_scale("dequant_int4", scale, N)
    if _native.on_cpu("dequant_int4", packed, scale,
                      each=((torch.uint8,), _F32), meta=True):
        return dequant_int4_plain(packed, scale, K)
    out = torch.empty((K, N), dtype=torch.float32, device=packed.device)
    if K and N and not packed.is_meta:
        lib = _native.library("quant")
        _launch("dequant_int4", lib.repro_dequant_int4, packed.data_ptr(),
                scale.data_ptr(), out.data_ptr(), K, N, device=packed.device)
    return out


def matmul_dequant_int8(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 or bf16; q (K, N) int8; scale (1, N) f32 -> (M, N) in
    x's dtype. On the card the kernel runs along ``plan_f32_gemm(M, N,
    K)``."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"matmul_dequant_int8: bad shapes {tuple(x.shape)} "
                         f"x {tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    _check_scale("matmul_dequant_int8", scale, N)
    if _native.on_cpu("matmul_dequant_int8", x, q, scale,
                      each=(_X, (torch.int8,), _F32)):
        return matmul_dequant_int8_plain(x, q, scale)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        lib = _native.library("quant")
        fn = (lib.repro_matmul_dequant_int8_bf16 if x.dtype == torch.bfloat16
              else lib.repro_matmul_dequant_int8_f32)
        launch_f32("matmul_dequant_int8", fn, plan_f32_gemm(M, N, K),
                   x.device, M * N, x.data_ptr(), q.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), M, N, K)
        _count("matmul_dequant_int8")
    return out


def q_loader(q: torch.Tensor, M: int, path: str) -> int:
    """Bytes of a row of ``q`` (int8 (K, N), or int4's packed ((K+1)//2,
    N)) that one load (skinny path) or copy (tile path) of the
    ``matmul_dequant_int8`` / ``matmul_dequant_int4`` kernels takes, as
    their launch picks them: 16 where every row starts on a 16-byte
    boundary (on the skinny path only for M <= 4, whose 16 columns of
    accumulators a row fit the registers), else 4 where rows start on a
    4-byte boundary, else 1."""
    N, ptr = q.shape[1], q.data_ptr()
    if ptr % 16 == 0 and N % 16 == 0 and (path == "tile" or M <= 4):
        return 16
    return 4 if ptr % 4 == 0 and N % 4 == 0 else 1


def matmul_dequant_int4(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, K: int) -> torch.Tensor:
    """x (M, K) f32 or bf16; packed ((K+1)//2, N) uint8; scale (1, N) f32
    -> (M, N) in x's dtype. x is not padded. On the card the kernel runs
    along ``plan_f32_gemm(M, N, K)``."""
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"matmul_dequant_int4: x {tuple(x.shape)} is not "
                         f"(M, {K})")
    _check_packed("matmul_dequant_int4", packed, K)
    M, N = x.shape[0], packed.shape[1]
    _check_scale("matmul_dequant_int4", scale, N)
    if _native.on_cpu("matmul_dequant_int4", x, packed, scale,
                      each=(_X, (torch.uint8,), _F32)):
        return matmul_dequant_int4_plain(x, packed, scale, K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        lib = _native.library("quant")
        fn = (lib.repro_matmul_dequant_int4_bf16 if x.dtype == torch.bfloat16
              else lib.repro_matmul_dequant_int4_f32)
        launch_f32("matmul_dequant_int4", fn, plan_f32_gemm(M, N, K),
                   x.device, M * N, x.data_ptr(), packed.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), M, N, K)
        _count("matmul_dequant_int4")
    return out
