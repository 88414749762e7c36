"""Mixture-of-Experts layer: top-k router and a capacity-blocked grouped
FFN — the port of ``repro/models/moe.py`` (forward, without a mesh).

Routing is all device work, with no host sync per layer: the router's
logits in f32 (the ``matmul`` kernel), softmax, the top k by a stable
descending sort (the k largest in descending order, ties to the lower
expert index, as ``jax.lax.top_k`` returns them), a stable ``argsort`` of
the flat expert ids, per-expert counts by ``index_add_`` (``bincount``
reads its input's max back to the host on a CUDA tensor) and ``cumsum``
for the groups. The capacity C is a host integer from T, k, E and
``moe_capacity_factor``.

``_gffn_blocks`` replaces the reference's ``lax.scan`` over experts with
three launches of the ``gmm_blocks`` kernel on capacity blocks: expert e's
block is the C rows of the expert-sorted tokens from ``offsets[e]`` (padded
by C rows, so a block may run into the next expert's rows); rows at or
past the group's size are zeroed (tokens beyond C are dropped), and the
blocks are added back at their rows. Each row receives exactly one
non-zero term, so the scatter-add is exact in bf16.

The custom VJPs and ``grouped_matmul`` wait for the training slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

# tokens per routed block: longer streams run as sequential blocks so the
# sorted and blocked buffers stay bounded (the reference's constant)
MOE_TOKEN_BLOCK = 16_384


def moe_init(cfg, g: torch.Generator, n: int) -> dict:
    """``n`` layers' MoE weights stacked (n, ...), the reference's shapes
    and scales (``moe_init``), drawn from ``g`` on ``g.device``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = getattr(torch, cfg.dtype)

    def normal(shape, scale, dtype):
        return (torch.randn((n, *shape), generator=g, dtype=torch.float32,
                            device=g.device) * scale).to(dtype)

    scale = 1.0 / math.sqrt(d)
    return {
        "router": normal((d, E), scale, torch.float32),
        "w_gate": normal((E, d, ff), scale, dt),
        "w_up": normal((E, d, ff), scale, dt),
        "w_down": normal((E, ff, d), 1.0 / math.sqrt(ff), dt),
    }


def capacity(T: int, cfg) -> int:
    """Static rows per expert block (``moe.py:102-104`` of the reference)."""
    k, E = cfg.top_k, cfg.num_experts
    cap = getattr(cfg, "moe_capacity_factor", 2.0)
    C = int(math.ceil(T * k / E * cap / 8.0)) * 8
    return max(8, min(C, T * k))


def route(xf: torch.Tensor, router: torch.Tensor, cfg):
    """(probs (T,E) f32, top_p (T,k) f32 renormalized, top_e (T,k) int64)."""
    logits = L._mm(xf.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def _counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """``bincount(idx, minlength=E)`` for ids < E, without a host sync."""
    return torch.zeros(E, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def _local_moe(xf: torch.Tensor, router, w_gate, w_up, w_down, cfg):
    """MoE over a flat token block (T, d). Returns (y (T, d), aux)."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.top_k
    probs, top_p, top_e = route(xf, router, cfg)

    # load-balance aux loss
    frac = _counts(top_e[:, 0], E).to(torch.float32) / T
    aux = torch.sum(frac * torch.mean(probs, dim=0)) * E

    flat_e = top_e.reshape(T * k)
    perm = torch.argsort(flat_e, stable=True)     # stable sort by expert id
    xs = xf[perm // k]                            # (T*k, d), expert-sorted
    group_sizes = _counts(flat_e, E)
    ys = _grouped_ffn(xs, group_sizes, w_gate, w_up, w_down, capacity(T, cfg))

    y = ys[torch.argsort(perm)].reshape(T, k, d)
    # bf16 products, summed over k in f32 and rounded once (jnp.sum's
    # upcast of a bf16 reduction)
    y = (y * top_p[..., None].to(y.dtype)).to(torch.float32).sum(dim=1)
    return y.to(xf.dtype), aux


def _grouped_ffn(xs, group_sizes, w_gate, w_up, w_down, C: int):
    """Expert-blocked SwiGLU over expert-sorted tokens xs (M, d)."""
    M = xs.shape[0]
    offsets = torch.cumsum(group_sizes, dim=0) - group_sizes
    xs_pad = F.pad(xs, (0, 0, 0, C))
    return _gffn_blocks(xs_pad, offsets, group_sizes, w_gate, w_up, w_down,
                        C)[:M]


def _gffn_blocks(xs_pad, offsets, group_sizes, w_gate, w_up, w_down, C):
    E = group_sizes.shape[0]
    d_out = w_down.shape[-1]
    ar = torch.arange(C, device=xs_pad.device)
    rows = offsets[:, None] + ar[None, :]                      # (E, C)
    blk = xs_pad[rows]                                         # (E, C, d)
    # rows past a group's size come out of the kernels as zeros, and an
    # expert with no rows reads none of its weights; the mask below keeps
    # the output the reference's either way
    gs = group_sizes.to(torch.int32)
    h = (F.silu(ops.gmm_blocks(blk, w_gate, gs))
         * ops.gmm_blocks(blk, w_up, gs))
    yb = ops.gmm_blocks(h, w_down, gs)                         # (E, C, d_out)
    yb = torch.where((ar[None, :] < group_sizes[:, None])[..., None], yb,
                     torch.zeros((), dtype=yb.dtype, device=yb.device))
    y = torch.zeros((xs_pad.shape[0], d_out), dtype=xs_pad.dtype,
                    device=xs_pad.device)
    return y.index_add_(0, rows.reshape(-1), yb.reshape(E * C, d_out))


def _blocked_local_moe(xf, router, wg, wu, wd, cfg):
    T = xf.shape[0]
    if T <= MOE_TOKEN_BLOCK:
        return _local_moe(xf, router, wg, wu, wd, cfg)
    nb = (T + MOE_TOKEN_BLOCK - 1) // MOE_TOKEN_BLOCK
    while T % nb != 0:
        nb += 1
    outs = [_local_moe(xb, router, wg, wu, wd, cfg)
            for xb in xf.reshape(nb, T // nb, xf.shape[1])]
    return (torch.cat([y for y, _ in outs]),
            torch.mean(torch.stack([a for _, a in outs])))


def moe_apply(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the switch-transformer load-balance
    aux loss)."""
    B, S, d = x.shape
    y, aux = _blocked_local_moe(x.reshape(B * S, d), p["router"], p["w_gate"],
                                p["w_up"], p["w_down"], cfg)
    return y.reshape(B, S, d), aux
