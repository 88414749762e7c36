"""Core layer library: norms, RoPE, attention (prefill and decode), MLP —
the port of ``repro/models/layers.py``.

Functions take and return torch tensors; parameters are plain dicts.
Computation is in the tensors' dtype (bf16 in the deployed model) with f32
norm and softmax reductions, as in the reference. Every matrix product
goes through ``kernels.ops.matmul`` (a 3-D activation is reshaped to 2-D
around the call) and the prefill attention of ``attn_apply_seq`` through
``kernels.ops.flash_attention``: on a CUDA tensor those launch the
hand-written kernels, on a CPU tensor their plain versions.

``full_attention`` stays as the reference computes it — scores rounded to
the input dtype before the f32 softmax (``layers.py:89`` of the
reference) — and is the plain whole-block reference of the tests.

``attn_decode_step`` is the reference's unsharded decode path: one token
against a ring-buffer KV cache (optionally int8 with per-entry scales),
read through ``kernels.ops.decode_attention``. It writes the new entry
into the cache tensors in place (the reference returns updated copies)
and returns them. Its position is a Python int or, as the reference's
traced ``pos``, a 0-d integer tensor on the cache's device: then RoPE's
positions, the ring slot and the writes are computed on the device, and
one CUDA graph of the step serves every position. The sharded read
(``_flash_decode_sharded``) and the sequence-parallel prefill need a
device mesh and stay out of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -2.0e38  # large-negative float that survives bf16/f32 casts


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) on the matmul kernel. A K-major ``w`` (``w.T``
    contiguous, e.g. the tied head's ``embed.T``) goes to the kernel as it
    is, read in place; any other strided ``w`` is copied."""
    lead = x.shape[:-1]
    if not (w.is_contiguous() or w.T.is_contiguous()):
        w = w.contiguous()
    y = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angle = positions.to(torch.float32)[..., None] * freq  # (..., S, half)
    cos = torch.cos(angle)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angle)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: Optional[int]) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk): causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def full_attention(
    q: torch.Tensor,      # (B, S, H, D)
    k: torch.Tensor,      # (B, S, KV, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, S)
    k_pos: torch.Tensor,  # (B, S)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Materialized masked attention (the reference's prefill path)."""
    B, S, H, D = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, H // kv)
    v = _repeat_kv(v, H // kv)
    # the product in q's dtype with an f32 accumulator, as XLA computes a
    # bf16 einsum; rounded to q's dtype, then widened for the softmax
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)).to(q.dtype).to(torch.float32)
    scores = scores / math.sqrt(D)
    scores = _softcap(scores, softcap)
    mask = attention_scores_mask(q_pos, k_pos, window)[:, None]  # (B,1,Sq,Sk)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(_mm(x, p["w_gate"])) * _mm(x, p["w_up"])
    return _mm(h, p["w_down"])


# ---------------------------------------------------------------------------
# attention apply (sequence mode: prefill)
# ---------------------------------------------------------------------------
def attn_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _mm(x, p["wq"]).reshape(B, S, H, hd)
    k = _mm(x, p["wk"]).reshape(B, S, KV, hd)
    v = _mm(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_seq(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                   *, window: Optional[int] = None):
    """Self-attention over a full prefill sequence (positions 0..S-1, the
    flash kernel's causal and window masks). Returns (out, (k, v)) so
    callers can keep the KV for cache initialisation."""
    B, S, _ = x.shape
    q, k, v = attn_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=window,
                              softcap=cfg.attn_softcap)
    out = _mm(out.reshape(B, S, cfg.num_heads * cfg.head_dim), p["wo"])
    return out, (k, v)


# ---------------------------------------------------------------------------
# attention apply (decode: one token against the KV cache)
# ---------------------------------------------------------------------------
_INV_127 = float(np.float32(1.0 / 127.0))


def _quantize_kv(k: torch.Tensor):
    """(B, 1, KV, hd) -> (int8 values, f32 scale (B, 1, KV)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does; the scale
    is ``amax · f32(1/127)``, which is what XLA compiles the reference's
    ``/ 127.0`` to under ``jit`` (its served path)."""
    kf = k.to(torch.float32)
    amax = torch.amax(torch.abs(kf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) * _INV_127
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _decode_positions(pos, B: int, W: int, device):
    """The (B,) int32 positions of a decode step and its ring slot. An int
    ``pos`` gives the slot as an int; a 0-d tensor ``pos`` a (1,) int64
    index on its device, ``pos mod W`` computed there (nothing is read
    back to the host)."""
    if isinstance(pos, torch.Tensor):
        p = pos.reshape(1)
        return (p.to(torch.int32).expand(B).contiguous(),
                torch.remainder(p.to(torch.int64), W))
    pos = int(pos)
    return torch.full((B,), pos, dtype=torch.int32, device=device), pos % W


def _ring_write(cache: torch.Tensor, slot, new: torch.Tensor) -> None:
    """``new`` (B, 1, ...) into entry ``slot`` of ``cache`` (B, W, ...), in
    place: a slice for an int slot, ``index_copy_`` for a device index."""
    if isinstance(slot, int):
        cache[:, slot] = new[:, 0]
    else:
        cache.index_copy_(1, slot, new.to(cache.dtype))


def attn_decode_step(
    p: dict,
    x: torch.Tensor,        # (B, 1, d)
    cache_k: torch.Tensor,  # (B, W, KV, hd), int8 when quantized
    cache_v: torch.Tensor,
    pos,                    # int or 0-d int tensor: the new token's position
    cfg,
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, W, KV) f32 if int8 cache
    v_scale: Optional[torch.Tensor] = None,
):
    """One decode step. The cache is a ring buffer of length W; for full
    attention W == max_len and no entry is ever overwritten. Writes the
    new entry at slot ``pos % W`` in place and returns
    (out, (cache_k, cache_v[, k_scale, v_scale]))."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cache_k.shape[1]
    quant = k_scale is not None
    q = _mm(x, p["wq"]).reshape(B, 1, H, hd)
    k = _mm(x, p["wk"]).reshape(B, 1, KV, hd)
    v = _mm(x, p["wv"]).reshape(B, 1, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    posv, slot = _decode_positions(pos, B, W, x.device)
    q = rope(q, posv[:, None], cfg.rope_theta)
    k = rope(k, posv[:, None], cfg.rope_theta)
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for cache, new in ((cache_k, kq), (cache_v, vq), (k_scale, ks),
                           (v_scale, vs)):
            _ring_write(cache, slot, new)
    else:
        _ring_write(cache_k, slot, k)
        _ring_write(cache_v, slot, v)
    out = ops.decode_attention(q[:, 0].contiguous(), cache_k, cache_v, posv,
                               window=window, softcap=cfg.attn_softcap,
                               k_scale=k_scale, v_scale=v_scale)
    out = _mm(out.reshape(B, 1, H * hd), p["wo"])
    caches = ((cache_k, cache_v, k_scale, v_scale) if quant
              else (cache_k, cache_v))
    return out, caches
