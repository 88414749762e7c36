"""Grouped matmul over capacity blocks for Hopper — the port of
``repro/kernels/gmm.py`` (``gmm_blocks``, ``_gmm_kernel``).

x (E, C, d), expert-sorted tokens gathered into fixed-capacity blocks (what
``models.moe._gffn_blocks`` forms), times per-expert weights w (E, d, n),
gives (E, C, n): one GEMM per expert with an f32 accumulator, out in x's
dtype. float32 or bfloat16, w in x's dtype. With ``group_sizes`` ((E,)
int32 on x's device), output rows r >= group_sizes[e] of expert e are
zero; without it the function is exactly the Pallas kernel's.

Kernels (``csrc/gmm.cu``), the expert on ``blockIdx.z``, each block
reading the contiguous weight rows of its expert and column tile; ragged
C, d and n masked in the kernel, nothing padded in device memory. bf16:
the tensor-core template ``csrc/gemm_bf16_tc.cuh`` along the path that
``matmul.plan_bf16_gemm`` picks for (C, n, d, E): the skinny path (one
``mma.sync`` tile of 16 rows streaming a 64-column slab of w once) at
decode's C = 8, the ``wgmma`` tile path at a prefill's C = 208. f32: the
f32 path template ``csrc/gemm_f32_paths.cuh`` (IEEE FMA, no TF32) along
``plan_f32_gemm(C, n, d, batch=E, row_limit=True)``: the batched
skinny path at decode's C = 8 (each block streams 128 columns of its
expert's w once, x's rows in shared memory), the batched tile path at a
prefill's C = 208 (128 x 128 tiles); the stream path, which takes no row
limit, is never planned. The kernels read ``group_sizes`` themselves (no
host sync, so a step stays capturable in a CUDA graph) as each expert's
row limit: rows past it are never read from x and are stored as zeros,
and a block whose rows all lie past it copies no weights, so an expert
with no rows reads none of its weights. A K split's partials of those
rows are zeros too.

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32 on the CUDA cores): granite-moe-3b-a800m (E 40, d 1536, n
512) at decode has C = 8; without group sizes each projection reads all
40 experts' weights, 62.9 MB in bf16, 125.8 MB in f32, for 0.25 GFLOP:
bound by bytes (0.019 ms, 0.038 ms). A decode step routes 8 experts a
token, so with group sizes it reads at most 8 experts' weights at batch 1
(12.6 MB, 0.004 ms in bf16; 25.2 MB, 0.0075 ms in f32). At a 512-token
prefill C = 208: 97 MB against 13.1 GFLOP, bound by bytes at the
tensor-core rate in bf16 (0.029 ms) and by operations in f32 (0.195
ms).

Training. ``w`` may also be K-major, a view whose ``w.transpose(1, 2)``
is contiguous: ``gmm_blocks(dy, w.transpose(1, 2), group_sizes)`` is the
backward's dx = dy·wᵀ per expert with the forward's weight (E, d, n) read
in place, as ``matmul``'s dx reads ``w.T``, on both templates (bf16: the
K-major B of either path; f32: the batched tile path, which
``plan_f32_gemm(C, n, d, True, E, True)`` takes at any C). ``gmm_blocks_dw``
is the weight gradient, dw[e] = x[e]ᵀ·dy[e] with x (E, C, d) and dy (E, C,
n), out (E, d, n) in x's dtype with an f32 accumulator, contracted over
the first ``group_sizes[e]`` rows only (the reference's ``blk.T @ dg`` in
``_grouped_ffn_bwd``, whose masked rows add zeros). Its kernels
(``csrc/gmm_dw.cu``) read x and dy in place, with no copy: the
contraction runs over the token rows, so x is the product's A operand
M-major. They take the group sizes as each expert's K limit: rows past it
never reach the result, whatever they hold (the next expert's tokens), a
K step wholly past it is not taken, and an expert with no rows writes
zeros. ``matmul.plan_gmm_dw`` picks the route from the shapes and the
operands' alignment: in bf16 with d and n multiples of 8 and 16-byte
aligned bases, the "tma" kernel (persistent blocks, one an SM, a TMA
producer warp feeding a 5-deep ring to two ``wgmma`` warpgroups, 128 x 128
output tiles; the rows past a group zeroed in shared memory); any other
bf16 shape the ``cp.async`` tile path of ``gemm_bf16_tc.cuh`` with its A
read M-major (``plan_bf16_gemm``'s tiles and split, never the skinny
path); f32 the batched tile path of ``gemm_f32_paths.cuh`` with its A read
M-major (``plan_f32_gemm``'s tile plan). At granite-moe-3b-a800m's
training microbatch (E 40, C 824, d 1536, n 512; ~410 rows an expert)
dw is bound by its bytes in bf16 (0.039 ms routed) and by operations in
f32; the K limit halves its reads and work against full blocks. Neither
wrapper is differentiable itself: the MoE layer's autograd Functions
(``models.moe``) call them.

``gmm_blocks_plain`` is the plain version (``ref.gmm_ref``): the f32
einsum, cast to x's dtype, rows past the group sizes set to zero;
``gmm_blocks_dw_plain`` the f32 einsum over the rows within the group
sizes, cast. On a CPU tensor a wrapper runs its plain version; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
``launches`` counts kernel launches only (a split-K launch and its
reduction count once).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _native
from repro_torch.kernels.matmul import (count_gemm_path, launch_bf16,
                                        launch_f32, plan_bf16_gemm,
                                        plan_f32_gemm, plan_gmm_dw)

launches = {"gmm_blocks": 0, "gmm_blocks_dw": 0}
_lock = threading.Lock()


def _kept(C: int, group_sizes: torch.Tensor, device) -> torch.Tensor:
    """(E, C, 1) True at the rows r < group_sizes[e] of each expert."""
    return (torch.arange(C, device=device)[None, :]
            < group_sizes.to(device)[:, None])[..., None]


def gmm_blocks_plain(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """f32-accumulated per-expert x[e] @ w[e], cast to x's dtype; rows
    r >= group_sizes[e] of expert e are zero where group sizes are given."""
    y = torch.einsum("ecd,edn->ecn", x.to(torch.float32), w.to(torch.float32))
    if group_sizes is not None:
        y = torch.where(_kept(x.shape[1], group_sizes, x.device), y,
                        torch.zeros((), device=y.device))
    return y.to(x.dtype)


def gmm_blocks_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                        group_sizes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """f32-accumulated per-expert x[e]ᵀ @ dy[e] over the rows r <
    group_sizes[e] (all rows without group sizes), cast to x's dtype."""
    xf, dyf = x.to(torch.float32), dy.to(torch.float32)
    if group_sizes is not None:
        keep = _kept(x.shape[1], group_sizes, x.device)
        zero = torch.zeros((), device=x.device)
        xf, dyf = torch.where(keep, xf, zero), torch.where(keep, dyf, zero)
    return torch.einsum("ecd,ecn->edn", xf, dyf).to(x.dtype)


def _group_sizes_arg(kernel: str, group_sizes, x: torch.Tensor):
    """``group_sizes``' device pointer (or None) for a CUDA launch."""
    if group_sizes is None:
        return None
    if group_sizes.device != x.device or group_sizes.dtype != torch.int32 \
            or not group_sizes.is_contiguous():
        raise TypeError(f"{kernel}: the CUDA kernel takes group_sizes as "
                        f"contiguous int32 on x's device")
    return group_sizes.data_ptr()


def _check_group_sizes(kernel: str, group_sizes, E: int) -> None:
    if group_sizes is not None and tuple(group_sizes.shape) != (E,):
        raise ValueError(f"{kernel}: group_sizes {tuple(group_sizes.shape)}"
                         f" for {E} experts")


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


def gmm_blocks_cost(out, x, w, group_sizes=None) -> Tuple[float, float]:
    """Every capacity block: 2·E·C·d·n; x, w and the group sizes read
    once, the output written once. The group sizes lie on the device (a
    dry run has none), so rows past them count too: an upper bound of the
    work a routing needs."""
    E, C, d = x.shape
    n = w.shape[2]
    return (2 * E * C * d * n, x.element_size() * (E * C * d + E * C * n)
            + w.element_size() * E * d * n
            + (0 if group_sizes is None else 4 * E))


def gmm_blocks_dw_cost(out, x, dy, group_sizes=None) -> Tuple[float, float]:
    """Every row of the capacity blocks: 2·E·C·d·n; x, dy and the group
    sizes read once, dw written once (an upper bound, as for
    ``gmm_blocks``)."""
    E, C, d = x.shape
    n = dy.shape[2]
    return (2 * E * C * d * n, x.element_size() * (E * C * d + E * d * n)
            + dy.element_size() * E * C * n
            + (0 if group_sizes is None else 4 * E))


@_native.costed("gmm_blocks", gmm_blocks_cost)
def gmm_blocks(x: torch.Tensor, w: torch.Tensor,
               group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, n) -> (E, C, n) in x's dtype; rows past
    ``group_sizes`` ((E,) int32) zero. ``w`` contiguous, or K-major (its
    ``transpose(1, 2)`` contiguous, read in place)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm_blocks: bad shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    _check_group_sizes("gmm_blocks", group_sizes, x.shape[0])
    # any other strides reach on_cpu as they are: fine on the CPU, refused
    # (not contiguous) on the card
    kmajor = not w.is_contiguous() and w.transpose(1, 2).is_contiguous()
    if _native.on_cpu("gmm_blocks", x, w.transpose(1, 2) if kmajor else w,
                      dtypes=(torch.float32, torch.bfloat16), meta=True):
        if group_sizes is not None and group_sizes.device.type != "cpu":
            raise ValueError("gmm_blocks: group_sizes on another device")
        return gmm_blocks_plain(x, w, group_sizes)
    gs_ptr = _group_sizes_arg("gmm_blocks", group_sizes, x)
    E, C, d = x.shape
    n = w.shape[2]
    out = torch.empty((E, C, n), dtype=x.dtype, device=x.device)
    if E and C and n and not x.is_meta:
        lib = _native.library("gmm")
        args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), gs_ptr, E, C, d,
                n, int(kmajor))
        if x.dtype == torch.bfloat16:
            launch_bf16("gmm_blocks", lib.repro_gmm_blocks_bf16,
                        plan_bf16_gemm(C, n, d, E), x.device, E * C * n,
                        *args)
        else:
            launch_f32("gmm_blocks", lib.repro_gmm_blocks_f32,
                       plan_f32_gemm(C, n, d, kmajor, E, True), x.device,
                       E * C * n, *args)
        _count("gmm_blocks")
    return out


@_native.costed("gmm_blocks_dw", gmm_blocks_dw_cost)
def gmm_blocks_dw(x: torch.Tensor, dy: torch.Tensor,
                  group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, d)ᵀ @ dy (E, C, n) -> (E, d, n) in x's dtype, expert e
    contracted over its first ``group_sizes[e]`` rows ((E,) int32; all C
    without them)."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"gmm_blocks_dw: bad shapes {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    _check_group_sizes("gmm_blocks_dw", group_sizes, x.shape[0])
    if _native.on_cpu("gmm_blocks_dw", x, dy,
                      dtypes=(torch.float32, torch.bfloat16), meta=True):
        if group_sizes is not None and group_sizes.device.type != "cpu":
            raise ValueError("gmm_blocks_dw: group_sizes on another device")
        return gmm_blocks_dw_plain(x, dy, group_sizes)
    gs_ptr = _group_sizes_arg("gmm_blocks_dw", group_sizes, x)
    E, C, d = x.shape
    n = dy.shape[2]
    out = torch.empty((E, d, n), dtype=x.dtype, device=x.device)
    if E and d and n and not x.is_meta:
        lib = _native.library("gmm_dw")
        aligned = (x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
                   and out.data_ptr() % 16 == 0)
        plan = plan_gmm_dw(d, n, C, E, x.dtype, aligned)
        args = (x.data_ptr(), dy.data_ptr(), out.data_ptr(), gs_ptr, E, C,
                d, n)
        if plan.path == "tma":
            with _native.on_device(x.device):
                rc = lib.repro_gmm_blocks_dw_tma_bf16(
                    *args, plan.blocks, _native.current_stream(x.device))
            _native.check(rc, "gmm_blocks_dw")
            count_gemm_path(plan)
        elif x.dtype == torch.bfloat16:
            launch_bf16("gmm_blocks_dw", lib.repro_gmm_blocks_dw_bf16, plan,
                        x.device, E * d * n, *args)
        else:
            launch_f32("gmm_blocks_dw", lib.repro_gmm_blocks_dw_f32, plan,
                       x.device, E * d * n, *args)
        _count("gmm_blocks_dw")
    return out
