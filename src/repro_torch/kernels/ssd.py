"""Mamba2 SSD chunked scan for Hopper — the port of ``repro/kernels/ssd.py``
(``ssd_scan``, ``_ssd_kernel``), extended to what ``models.ssm.ssd_chunked``
computes: an optional initial state and the final state.

x (B, S, H, P) and Bm, Cm (B, S, N) (G = 1: one B and C for every head) in
float32 or bfloat16; dt (B, S, H) after the softplus, A (H,) negative,
D (H,), and the states (B, H, P, N) in float32. S is a multiple of the
chunk Q. Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
float32), the layout ``ssd_chunked`` returns (the Pallas kernel keeps its
state as (N, P) and returns y only, from a zero state).

Kernel: ``csrc/ssd.cu``. One block per (b, h) walks the chunks in a loop
and keeps the f32 state in shared memory across them (the Pallas kernel's
sequential grid axis); within a chunk it works on 64-row sub-tiles and
computes the intra-chunk term only for column tiles on or below the
diagonal, taking exp(cum_i - cum_j) only where i >= j. f32 FMA on the CUDA
cores, no TF32. P <= 64, N <= 128: the kernel refuses anything larger, and
a chunk whose tiles do not fit in shared memory, with a CUDA error that
``_native.check`` raises.

Bound on an H100 SXM: the f32 operations. mamba2-2.7b (H 80, P 64, N 128,
Q 256) at S 1024: 4.07 GFLOP over the chunks' lower triangles with C·B^T
counted once per (b, chunk), as G = 1 allows, 0.061 ms at 67 TFLOP/s,
against about 24 MB moved (0.007 ms). The kernel recomputes C·B^T for every
head (6.7 GFLOP). 80 blocks at B 1 on 132 SMs; sharing C·B^T across heads
and tensor-core tiles are later work.

``ssd_scan_plain`` is the plain version: ``ssd_chunked``'s chunk loop as f32
einsums. On a CPU tensor the wrapper runs it; on a CUDA tensor it launches
the kernel or raises — there is no fallback. ``launches`` counts kernel
launches only.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _native

launches = {"ssd_scan": 0}
_lock = threading.Lock()


def _check(x, dt, A, Bm, Cm, D, chunk, init_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or tuple(Bm.shape) != (B, S, N)
            or tuple(Cm.shape) != (B, S, N)):
        raise ValueError(
            f"ssd_scan: shapes do not fit x {tuple(x.shape)}: dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}, D {tuple(D.shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)} is "
                         f"not {(B, H, P, N)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of chunk={chunk}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   chunk: int, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked``'s arithmetic with G = 1, chunk by chunk in f32."""
    _check(x, dt, A, Bm, Cm, D, chunk, init_state)
    f32 = torch.float32
    B, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H).to(f32)
    Bc = Bm.reshape(B, nc, Q, N).to(f32)
    Cc = Cm.reshape(B, nc, Q, N).to(f32)
    cum = torch.cumsum(dtc * A.to(f32), dim=2)   # within-chunk log-decay
    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        B_, C_, cum_ = Bc[:, c], Cc[:, c], cum[:, c]
        xdt = xc[:, c].to(f32) * dtc[:, c][..., None]            # (B,Q,H,P)
        # L[i,j] = exp(cum_i - cum_j) for i >= j (the exp of the masked
        # upper half may be inf; where() drops it before any product)
        diff = cum_[:, :, None, :] - cum_[:, None, :, :]          # (B,i,j,H)
        Lmat = torch.where(tri[None, :, :, None], torch.exp(diff),
                           torch.zeros((), dtype=f32, device=x.device))
        CB = torch.einsum("bin,bjn->bij", C_, B_)
        y_diag = torch.einsum("bij,bijh,bjhp->bihp", CB, Lmat, xdt)
        last = cum_[:, -1:, :]                                    # (B,1,H)
        new_contrib = torch.einsum("bjn,bjh,bjhp->bhpn", B_,
                                   torch.exp(last - cum_), xdt)
        y_off = torch.einsum("bin,bhpn,bih->bihp", C_, state,
                             torch.exp(cum_))
        state = state * torch.exp(last[:, 0])[..., None, None] + new_contrib
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan; returns (y, final_state (B,H,P,N) f32)."""
    _check(x, dt, A, Bm, Cm, D, chunk, init_state)
    f32 = torch.float32
    ts = [x, dt, A, Bm, Cm, D] + ([] if init_state is None else [init_state])
    io = (torch.float32, torch.bfloat16)
    if _native.on_cpu("ssd_scan", *ts,
                      each=[io, (f32,), (f32,), (x.dtype,), (x.dtype,),
                            (f32,), (f32,)][:len(ts)]):
        return ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=chunk,
                              init_state=init_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    lib = _native.library("ssd")
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    if B and S and H:
        fn = (lib.repro_ssd_scan_bf16 if x.dtype == torch.bfloat16
              else lib.repro_ssd_scan_f32)
        with _native.on_device(x.device):
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), D.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), final.data_ptr(), B, S, H, P, N, chunk,
                    _native.current_stream(x.device))
        _native.check(rc, "ssd_scan")
        with _lock:
            launches["ssd_scan"] += 1
    elif init_state is not None:
        final.copy_(init_state)
    else:
        final.zero_()
    return y, final

