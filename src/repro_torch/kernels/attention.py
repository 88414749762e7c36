"""Prefill flash attention for Hopper — the port of
``repro/kernels/attention.py::flash_attention`` (``_fa_kernel``).

q (B, S, H, D) and k, v (B, S, KV, D), bf16 or f32; the output is in q's
dtype. Scale 1/sqrt(D); causal mask, sliding window (``cols > rows -
window``), tanh softcap and GQA (kv head ``h // (H/KV)``). Query and key
positions are 0..S-1, as in a prefill.

Kernel: ``csrc/flash_attention.cu``. One block per (b, h, 64-row query
tile) walks the 64-key tiles in a loop with an online softmax whose m, l
and acc are f32 (the Pallas kernel carries them in VMEM across a
sequential grid axis, which Hopper's blocks do not have); the ragged end of
S is masked in the kernel instead of padded in device memory, and key tiles
that the causal and window masks cover fully are skipped. D is 32, 64 or
128. For bf16 inputs p is rounded to bf16 before P·V, as the Pallas kernel
casts p to v's dtype.

Bound on an H100 SXM: the cold-LLM prefill (S = 64) is bound by launch
latency; a long prefill (S = 2048, 15 heads, D = 64) by its ≈ 8 GFLOP of
the causal half at the 989 TFLOP/s bf16 peak (8 µs). This first kernel
runs its products on the CUDA cores in f32, so it stays far from that
bound; tensor-core tiles are later work.

``flash_attention_plain`` is the plain version (``flash_attention_ref``):
scores and softmax in f32 over the whole (S, S) matrix, cast to q's dtype
at the end. On a CPU tensor the wrapper runs it; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _native

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128)

launches = {"flash_attention": 0}
_lock = threading.Lock()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B,S,H,D) and k, v "
                         f"(B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) \
            or k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention in f32 over the whole score matrix."""
    _check(q, k, v)
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[None, :] <= idx[:, None]
    if window is not None:
        mask &= idx[None, :] > idx[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    _check(q, k, v)
    if _native.on_cpu("flash_attention", q, k, v,
                      dtypes=(torch.float32, torch.bfloat16)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"in {HEAD_DIMS}, got {D}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, "
                         f"got {window}")
    out = torch.empty_like(q)
    if B and S and H:
        lib = _native.library("flash_attention")
        fn = (lib.repro_flash_attention_bf16 if q.dtype == torch.bfloat16
              else lib.repro_flash_attention_f32)
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, H, k.shape[2], D, int(causal),
                    int(window) if window is not None else 0,
                    float(softcap) if softcap else 0.0,
                    torch.cuda.current_stream(q.device).cuda_stream)
        _native.check(rc, "flash_attention")
        with _lock:
            launches["flash_attention"] += 1
    return out
