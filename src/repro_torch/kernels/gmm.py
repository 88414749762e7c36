"""Grouped matmul over capacity blocks for Hopper — the port of
``repro/kernels/gmm.py`` (``gmm_blocks``, ``_gmm_kernel``).

x (E, C, d), expert-sorted tokens gathered into fixed-capacity blocks (what
``models.moe._gffn_blocks`` forms), times per-expert weights w (E, d, n),
gives (E, C, n): one GEMM per expert with an f32 accumulator, out in x's
dtype. float32 or bfloat16, w in x's dtype.

Kernel: ``csrc/gmm.cu``, the shared tiled GEMM of ``csrc/gemm_f32.cuh``
(64x64 block tile, K step 16, IEEE f32 FMA on the CUDA cores, no TF32)
with the expert on ``blockIdx.z``: each block reads the contiguous weight
rows of its expert and column tile. Ragged C, d and n are masked in the
kernel; nothing is padded in device memory.

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): granite-moe-3b-a800m
(E 40, d 1536, n 512, bf16) at decode has C = 8, so each projection reads
all 40 experts' weights, 62.9 MB, for 0.25 GFLOP: bound by bytes (0.019
ms). At a 512-token prefill C = 208: 97 MB against 13.1 GFLOP, still bound
by bytes at the tensor-core rate (0.029 ms). This first kernel runs its
products on the CUDA cores and wastes 56 of the 64 tile rows at C = 8;
skipping empty experts and fusing the capacity-block gather are later work.

``gmm_blocks_plain`` is the plain version (``ref.gmm_ref``): the f32
einsum, cast to x's dtype. On a CPU tensor the wrapper runs it; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _native

launches = {"gmm_blocks": 0}
_lock = threading.Lock()


def gmm_blocks_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32-accumulated per-expert x[e] @ w[e], cast to x's dtype."""
    return torch.einsum("ecd,edn->ecn", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def gmm_blocks(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, n) -> (E, C, n) in x's dtype."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm_blocks: bad shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if _native.on_cpu("gmm_blocks", x, w,
                      dtypes=(torch.float32, torch.bfloat16)):
        return gmm_blocks_plain(x, w)
    E, C, d = x.shape
    n = w.shape[2]
    out = torch.empty((E, C, n), dtype=x.dtype, device=x.device)
    if E and C and n:
        lib = _native.library("gmm")
        fn = (lib.repro_gmm_blocks_bf16 if x.dtype == torch.bfloat16
              else lib.repro_gmm_blocks_f32)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, n,
                    torch.cuda.current_stream(x.device).cuda_stream)
        _native.check(rc, "gmm_blocks")
        with _lock:
            launches["gmm_blocks"] += 1
    return out
