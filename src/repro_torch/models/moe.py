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

Training, the reference's two custom VJPs as ``torch.autograd.Function``s
(taken under grad, when an input requires it; inference keeps the plain
calls):

* ``_GroupedFFN`` (``_grouped_ffn``, reference ``moe.py:116-199``): the
  forward is the three ``gmm_blocks`` launches above; it saves xs, the
  group sizes and the three weights, not h. The backward follows
  ``_grouped_ffn_bwd``'s order and roundings: g and u recomputed by
  ``gmm_blocks``, dy masked past each group, dh = dyb·wdᵀ, dg and du from
  the SiLU's derivative, dblk = dg·wgᵀ + du·wuᵀ (each ``gmm_blocks``
  reading the forward's weight K-major in place) and dwd = hᵀ·dyb, dwg =
  blkᵀ·dg, dwu = blkᵀ·du (``gmm_blocks_dw``, contracted over each
  group's rows only): eight kernel launches, no atomics but the
  ``index_add_`` that adds dblk back at its rows, where each row receives
  exactly one non-zero term (dyb is masked), so its order cannot change a
  bit.
* ``GroupedMatmul`` (``grouped_matmul``, reference ``moe.py:33-56``):
  ``ragged_dot`` of x (M, d) sorted by group with w (E, d, n), on the
  kernels as capacity blocks of C = M rounded up to 8 rows (every group
  fits, and no host sync); dx = dy·wᵀ and dw a contraction over each
  group's rows. Nothing on the model's path calls it.

The token gather ``xf[perm // k]`` and the un-permute ``ys[inv]`` carry
explicit reverses (``_TokenGather``, ``_Permute``): the default backward of
the gather, a CUDA ``index_put_`` with accumulate, sums each token's k
rows in no fixed order; here they are gathered by ``inv`` and summed over
k in f32, rounded once, so two backward passes give the same bits. The
router differentiates through the f32 ``matmul`` Function, the softmax,
the sort's values and the renormalisation; the aux loss through
``mean(probs)`` (``frac`` is counts: no gradient), as in the reference.
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


def moe_init(cfg, g: torch.Generator, n: int, *, device=None) -> dict:
    """``n`` layers' MoE weights stacked (n, ...), the reference's shapes
    and scales (``moe_init``), drawn from ``g`` on ``device`` (default
    ``g.device``; ``"meta"``: shapes only)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = getattr(torch, cfg.dtype)
    dev = device or g.device

    def normal(shape, scale, dtype):
        return (torch.randn((n, *shape), generator=g, dtype=torch.float32,
                            device=dev) * scale).to(dtype)

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
    inv = torch.argsort(perm)
    xs = _TokenGather.apply(xf, perm, inv, k)     # (T*k, d), expert-sorted
    group_sizes = _counts(flat_e, E)
    ys = _grouped_ffn(xs, group_sizes, w_gate, w_up, w_down, capacity(T, cfg))

    y = _Permute.apply(ys, inv, perm).reshape(T, k, d)
    # bf16 products, summed over k in f32 and rounded once (jnp.sum's
    # upcast of a bf16 reduction)
    y = (y * top_p[..., None].to(y.dtype)).to(torch.float32).sum(dim=1)
    return y.to(xf.dtype), aux


class _TokenGather(torch.autograd.Function):
    """xs = xf[perm // k]: each token's k copies in expert order. Backward:
    dxf = dxs[inv].reshape(T, k, d) summed over k in f32 and rounded once,
    the same bits on every pass."""

    @staticmethod
    def forward(ctx, xf, perm, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xf[perm // k]

    @staticmethod
    def backward(ctx, dxs):
        (inv,) = ctx.saved_tensors
        dx = dxs[inv].reshape(-1, ctx.k, dxs.shape[1])
        return dx.to(torch.float32).sum(dim=1).to(dxs.dtype), None, None, None


class _Permute(torch.autograd.Function):
    """ys[inv] for a permutation ``inv``; backward: the gather by its
    inverse ``perm``."""

    @staticmethod
    def forward(ctx, ys, inv, perm):
        ctx.save_for_backward(perm)
        return ys[inv]

    @staticmethod
    def backward(ctx, dy):
        (perm,) = ctx.saved_tensors
        return dy[perm], None, None


def _differentiable(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _grouped_ffn(xs, group_sizes, w_gate, w_up, w_down, C: int):
    """Expert-blocked SwiGLU over expert-sorted tokens xs (M, d); under
    grad the ``_GroupedFFN`` Function."""
    if _differentiable(xs, w_gate, w_up, w_down):
        return _GroupedFFN.apply(xs, group_sizes, w_gate, w_up, w_down, C)
    return _grouped_ffn_fwd(xs, group_sizes, w_gate, w_up, w_down, C)


def _grouped_ffn_fwd(xs, group_sizes, w_gate, w_up, w_down, C: int):
    """``_grouped_ffn``'s forward on the kernels; with the plain versions
    swapped in for them, torch autograd differentiates it as it is (the
    reference a card's gradients are held to)."""
    M = xs.shape[0]
    xs_pad = F.pad(xs, (0, 0, 0, C))
    return _gffn_blocks(xs_pad, _offsets(group_sizes), group_sizes, w_gate,
                        w_up, w_down, C)[:M]


def _offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(group_sizes, dim=0) - group_sizes


def _block_rows(offsets: torch.Tensor, group_sizes: torch.Tensor, C: int):
    """(rows (E, C): expert e's block, the C rows from its offset; keep
    (E, C, 1): True within the group)."""
    ar = torch.arange(C, device=group_sizes.device)
    return (offsets[:, None] + ar[None, :],
            (ar[None, :] < group_sizes[:, None])[..., None])


def _zero_past(blocks: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, blocks, torch.zeros((), dtype=blocks.dtype,
                                                 device=blocks.device))


def _masked_blocks(t: torch.Tensor, rows, keep, C: int) -> torch.Tensor:
    """t (M, n) padded by C rows, gathered into blocks (E, C, n), zero past
    each group."""
    return _zero_past(F.pad(t, (0, 0, 0, C))[rows], keep)


def _scatter_blocks(blocks: torch.Tensor, rows, n_rows: int):
    """Blocks (E, C, n) added at their rows of a zero (n_rows, n) buffer;
    each row receives one non-zero term at most."""
    n = blocks.shape[-1]
    out = torch.zeros((n_rows, n), dtype=blocks.dtype, device=blocks.device)
    return out.index_add_(0, rows.reshape(-1), blocks.reshape(-1, n))


def _gffn_blocks(xs_pad, offsets, group_sizes, w_gate, w_up, w_down, C):
    rows, keep = _block_rows(offsets, group_sizes, C)          # (E, C)
    blk = xs_pad[rows]                                         # (E, C, d)
    # rows past a group's size come out of the kernels as zeros, and an
    # expert with no rows reads none of its weights; the mask below keeps
    # the output the reference's either way
    gs = group_sizes.to(torch.int32)
    h = (F.silu(ops.gmm_blocks(blk, w_gate, gs))
         * ops.gmm_blocks(blk, w_up, gs))
    yb = _zero_past(ops.gmm_blocks(h, w_down, gs), keep)       # (E, C, d_out)
    return _scatter_blocks(yb, rows, xs_pad.shape[0])


class _GroupedFFN(torch.autograd.Function):
    """``_grouped_ffn`` under autograd, the reference's custom VJP: the
    forward's three ``gmm_blocks`` launches; a backward of five
    ``gmm_blocks`` (g and u recomputed, dh, dblk's two products, the
    weights read K-major in place) and three ``gmm_blocks_dw`` launches,
    in ``_grouped_ffn_bwd``'s order and roundings."""

    @staticmethod
    def forward(ctx, xs, group_sizes, w_gate, w_up, w_down, C):
        ctx.C = C
        ctx.save_for_backward(xs, group_sizes, w_gate, w_up, w_down)
        return _grouped_ffn_fwd(xs, group_sizes, w_gate, w_up, w_down, C)

    @staticmethod
    def backward(ctx, dy):
        xs, group_sizes, wg, wu, wd = ctx.saved_tensors
        C, M = ctx.C, xs.shape[0]
        rows, keep = _block_rows(_offsets(group_sizes), group_sizes, C)
        gs = group_sizes.to(torch.int32)
        blk = F.pad(xs, (0, 0, 0, C))[rows]                    # (E, C, d)
        dyb = _masked_blocks(dy.to(xs.dtype), rows, keep, C)   # (E, C, d)
        g = ops.gmm_blocks(blk, wg, gs)
        u = ops.gmm_blocks(blk, wu, gs)
        gf = g.to(torch.float32)
        sg = torch.sigmoid(gf)
        silu_g = (gf * sg).to(g.dtype)
        h = silu_g * u
        dh = ops.gmm_blocks(dyb, wd.transpose(1, 2), gs)
        dwd = ops.gmm_blocks_dw(h, dyb, gs)
        du = dh * silu_g
        dsilu = (sg * (1 + gf * (1 - sg))).to(g.dtype)
        dg = dh * u * dsilu
        dwg = ops.gmm_blocks_dw(blk, dg, gs)
        dwu = ops.gmm_blocks_dw(blk, du, gs)
        dblk = (ops.gmm_blocks(dg, wg.transpose(1, 2), gs)
                + ops.gmm_blocks(du, wu.transpose(1, 2), gs))
        return (_scatter_blocks(dblk, rows, M + C)[:M], None, dwg, dwu, dwd,
                None)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """``ragged_dot``: x (M, d) sorted by group, rows of group e times w[e]
    (E, d, n) -> (M, n) in x's dtype; rows past the groups' sum are zero.
    Under grad the ``GroupedMatmul`` Function."""
    if _differentiable(x, w):
        return GroupedMatmul.apply(x, w, group_sizes)
    return _grouped_matmul_fwd(x, w, group_sizes)


def _gm_capacity(M: int) -> int:
    return max(8, -(-M // 8) * 8)


def _grouped_matmul_fwd(x, w, group_sizes):
    M, C = x.shape[0], _gm_capacity(x.shape[0])
    rows, keep = _block_rows(_offsets(group_sizes), group_sizes, C)
    yb = ops.gmm_blocks(_masked_blocks(x, rows, keep, C), w.contiguous(),
                        group_sizes.to(torch.int32))
    return _scatter_blocks(yb, rows, M + C)[:M]


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` under autograd, the reference's custom VJP: dx =
    ``gmm_blocks(dy blocks, wᵀ)`` (w read K-major in place) added back at
    the rows, dw = ``gmm_blocks_dw(x blocks, dy blocks)`` over each group's
    rows; both in x's dtype."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        w = w.contiguous()
        ctx.save_for_backward(x, w, group_sizes)
        return _grouped_matmul_fwd(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        M, C = x.shape[0], _gm_capacity(x.shape[0])
        rows, keep = _block_rows(_offsets(group_sizes), group_sizes, C)
        gs = group_sizes.to(torch.int32)
        dyb = _masked_blocks(dy.to(x.dtype), rows, keep, C)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _scatter_blocks(ops.gmm_blocks(dyb, w.transpose(1, 2), gs),
                                 rows, M + C)[:M]
        if ctx.needs_input_grad[1]:
            dw = ops.gmm_blocks_dw(_masked_blocks(x, rows, keep, C), dyb,
                                   gs).to(w.dtype)
        return dx, dw, None


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
