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

``gmm_blocks_plain`` is the plain version (``ref.gmm_ref``): the f32
einsum, cast to x's dtype, rows past the group sizes set to zero. On a CPU
tensor the wrapper runs it; on a CUDA tensor it launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches only
(a split-K launch and its reduction count once).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _native
from repro_torch.kernels.matmul import (launch_bf16, launch_f32,
                                        plan_bf16_gemm, plan_f32_gemm)

launches = {"gmm_blocks": 0}
_lock = threading.Lock()


def gmm_blocks_plain(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """f32-accumulated per-expert x[e] @ w[e], cast to x's dtype; rows
    r >= group_sizes[e] of expert e are zero where group sizes are given."""
    y = torch.einsum("ecd,edn->ecn", x.to(torch.float32), w.to(torch.float32))
    if group_sizes is not None:
        keep = (torch.arange(x.shape[1], device=x.device)[None, :]
                < group_sizes.to(x.device)[:, None])
        y = torch.where(keep[..., None], y, torch.zeros((), device=y.device))
    return y.to(x.dtype)


def gmm_blocks(x: torch.Tensor, w: torch.Tensor,
               group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, n) -> (E, C, n) in x's dtype; rows past
    ``group_sizes`` ((E,) int32) zero."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm_blocks: bad shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if group_sizes is not None and tuple(group_sizes.shape) != (x.shape[0],):
        raise ValueError(f"gmm_blocks: group_sizes {tuple(group_sizes.shape)}"
                         f" for {x.shape[0]} experts")
    if _native.on_cpu("gmm_blocks", x, w,
                      dtypes=(torch.float32, torch.bfloat16)):
        if group_sizes is not None and group_sizes.device.type != "cpu":
            raise ValueError("gmm_blocks: group_sizes on another device")
        return gmm_blocks_plain(x, w, group_sizes)
    gs_ptr = None
    if group_sizes is not None:
        if group_sizes.device != x.device or group_sizes.dtype != torch.int32 \
                or not group_sizes.is_contiguous():
            raise TypeError("gmm_blocks: the CUDA kernel takes group_sizes "
                            "as contiguous int32 on x's device")
        gs_ptr = group_sizes.data_ptr()
    E, C, d = x.shape
    n = w.shape[2]
    out = torch.empty((E, C, n), dtype=x.dtype, device=x.device)
    if E and C and n:
        lib = _native.library("gmm")
        args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), gs_ptr, E, C, d,
                n)
        if x.dtype == torch.bfloat16:
            launch_bf16("gmm_blocks", lib.repro_gmm_blocks_bf16,
                        plan_bf16_gemm(C, n, d, E), x.device, E * C * n,
                        *args)
        else:
            launch_f32("gmm_blocks", lib.repro_gmm_blocks_f32,
                       plan_f32_gemm(C, n, d, False, E, True), x.device,
                       E * C * n, *args)
        with _lock:
            launches["gmm_blocks"] += 1
    return out
