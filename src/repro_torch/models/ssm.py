"""Mamba2 (SSD, state-space duality) mixer — the port of
``repro/models/ssm.py``.

Sequence mode runs the chunked SSD scan on the ``ssd_scan`` kernel (its
plain version on a CPU tensor), from an optional initial state, and returns
the final state with y. Under grad the scan is ``ssd_scan``'s autograd
Function, whose backward is the ``ssd_scan_bwd`` kernel; the casts and
slices that feed it (``ssd_chunked``) keep the graph, the projections go
through the ``matmul`` kernel's Function (``layers._mm``), and
``causal_conv``, the SiLUs, the softplus and the gated norm are plain
PyTorch that autograd differentiates, as ``jax.grad`` does the
reference's. Decode is the O(1) recurrent step, plain PyTorch as in the
reference (which has no kernel for it). G = 1: one B and C for every head,
as in the mamba2 and zamba2 configs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """x: (B, S, C); w: (K, C). Returns (y, new_state=(B, K-1, C)); the
    products and the sum over the K taps in x's dtype, as the reference."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, 0:S] * w[0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k]
    return y, xp[:, S:]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                chunk: int, init_state: Optional[torch.Tensor] = None):
    """x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative, Bm and Cm
    (B,S,G,N) with G = 1, D (H,), init_state (B,H,P,N). Returns (y
    (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32), on ``ssd_scan``."""
    if Bm.shape[2] != 1:
        raise NotImplementedError("ssd_chunked: the port's scan takes G = 1")
    return ops.ssd_scan(
        x.contiguous(), dt.to(torch.float32).contiguous(),
        A.to(torch.float32).contiguous(), Bm[:, :, 0].contiguous(),
        Cm[:, :, 0].contiguous(), D.to(torch.float32).contiguous(),
        chunk=chunk,
        init_state=None if init_state is None
        else init_state.to(torch.float32).contiguous())


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor):
    """One recurrent step: x (B,H,P), dt (B,H), Bm/Cm (B,G,N), state
    (B,H,P,N) f32. Returns (y (B,H,P) in x's dtype, new state)."""
    f32 = torch.float32
    B_, H, P = x.shape
    G, N = Bm.shape[1], Bm.shape[2]
    if G == 1:
        Bh = Bm[:, 0][:, None].to(f32).expand(B_, H, N)
        Ch = Cm[:, 0][:, None].to(f32).expand(B_, H, N)
    else:
        Bh = torch.repeat_interleave(Bm.to(f32), H // G, dim=1)
        Ch = torch.repeat_interleave(Cm.to(f32), H // G, dim=1)
    dtf = dt.to(f32)
    decay = torch.exp(dtf * A.to(f32))                          # (B,H)
    upd = torch.einsum("bhp,bhn->bhpn", x.to(f32) * dtf[..., None], Bh)
    state = state * decay[..., None, None] + upd
    y = (torch.einsum("bhpn,bhn->bhp", state, Ch)
         + x.to(f32) * D.to(f32)[None, :, None])
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------
def mamba_init(cfg, g: torch.Generator, n: int, *, device=None) -> dict:
    """``n`` layers' mixer weights stacked (n, ...), the reference's tree,
    shapes and scales (``mamba_init``), drawn from ``g`` on ``device``
    (default ``g.device``; ``"meta"``: shapes only)."""
    d, di, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_heads
    N, K = cfg.ssm_state, cfg.ssm_conv_width
    dt = getattr(torch, cfg.dtype)
    dev = device or g.device

    def normal(shape, scale):
        return (torch.randn((n, *shape), generator=g, dtype=torch.float32,
                            device=dev) * scale).to(dt)

    def dense(shape):
        return normal(shape, 1.0 / math.sqrt(shape[0]))

    def per_layer(v):
        return v.to(dev).expand(n, *v.shape).clone()

    return {
        "in_x": dense((d, di)), "in_z": dense((d, di)),
        "in_B": dense((d, N)), "in_C": dense((d, N)), "in_dt": dense((d, H)),
        "conv_x": normal((K, di), 1.0 / math.sqrt(K)),
        "conv_B": normal((K, N), 1.0 / math.sqrt(K)),
        "conv_C": normal((K, N), 1.0 / math.sqrt(K)),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, H,
                                                    dtype=torch.float32))),
        "D": per_layer(torch.ones((H,), dtype=torch.float32)),
        "dt_bias": per_layer(torch.full((H,), -2.0, dtype=torch.float32)),
        "gate_norm": torch.zeros((n, di), dtype=dt, device=dev),
        "out": dense((di, d)),
    }


def _in_proj(p, x, cfg, conv_states):
    z = L._mm(x, p["in_z"])
    xi = L._mm(x, p["in_x"])
    Bm = L._mm(x, p["in_B"])
    Cm = L._mm(x, p["in_C"])
    dtr = L._mm(x, p["in_dt"])
    cs = conv_states if conv_states is not None else (None, None, None)
    xi, sx = causal_conv(xi, p["conv_x"], cs[0])
    Bm, sB = causal_conv(Bm, p["conv_B"], cs[1])
    Cm, sC = causal_conv(Cm, p["conv_C"], cs[2])
    return z, F.silu(xi), F.silu(Bm), F.silu(Cm), dtr, (sx, sB, sC)


def _out_proj(p, y, z, cfg):
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return L._mm(y, p["out"])


def mamba_apply_seq(p: dict, x: torch.Tensor, cfg, conv_states=None,
                    ssm_state=None):
    """Sequence mode, x (B, S, d) with S a multiple of ``cfg.ssm_chunk``.
    Returns (y, (conv_states, ssm_state))."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, Bm, Cm, dtr, conv = _in_proj(p, x, cfg, conv_states)
    dt = F.softplus(dtr.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xi.reshape(B, S, H, P), dt, A, Bm[:, :, None, :],
                           Cm[:, :, None, :], p["D"], chunk=cfg.ssm_chunk,
                           init_state=ssm_state)
    return _out_proj(p, y.reshape(B, S, cfg.ssm_inner), z, cfg), (conv, state)


def mamba_decode_step(p: dict, x: torch.Tensor, cfg, conv_states,
                      ssm_state):
    """x: (B, 1, d). Returns (y (B,1,d), (conv_states, ssm_state))."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, Bm, Cm, dtr, conv = _in_proj(p, x, cfg, conv_states)
    dt = F.softplus(dtr[:, 0].to(torch.float32) + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(xi[:, 0].reshape(B, H, P), dt, A,
                               Bm[:, 0][:, None, :], Cm[:, 0][:, None, :],
                               p["D"], ssm_state)
    return _out_proj(p, y.reshape(B, 1, cfg.ssm_inner), z, cfg), (conv, state)


def mamba_state_init(cfg, batch: int, dtype, device="cuda") -> dict:
    """Zero conv and SSM states of one mamba layer, on the card unless
    ``device`` says otherwise; raises without one."""
    device = resolve_device(device)
    K = cfg.ssm_conv_width

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "conv_x": zeros(batch, K - 1, cfg.ssm_inner),
        "conv_B": zeros(batch, K - 1, cfg.ssm_state),
        "conv_C": zeros(batch, K - 1, cfg.ssm_state),
        "ssm": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     dt=torch.float32),
    }
