"""Blocked GEMMs for Hopper — the port of ``repro/kernels/matmul.py``.

Two wrappers, each with its plain PyTorch version beside it:

  * ``matmul`` replaces the Pallas ``matmul`` (``_mm_kernel``): (M,K)x(K,N)
    with an f32 accumulator, in f32 (f32 out), in bf16 (bf16 out, each
    output rounded once) or bf16 in with f32 out (``out_dtype=float32``:
    the accumulator stored as it is, ``jnp.dot(bf16, bf16,
    preferred_element_type=f32)``). Consumers: ``LinearDirect`` and the
    patch GEMM of ``ConvIm2col`` in f32; the seven projections of every
    decoder block and the LM head of the cold-LLM graph in bf16
    (``models.layers``, ``core.llm_graph``); ``LinearLowPrecision`` with
    f32 out.
  * ``matmul_packed`` replaces the Pallas ``matmul_packed``
    (``_mm_packed_kernel``): it reads ``LinearPacked``'s (N/128, K/128,
    128, 128) layout in place, so each K step of a block loads rows of one
    contiguous 64 KB weight tile — the point of the packing transform. x
    is f32 or bf16 and the result is in x's dtype, as in the Pallas
    kernel.

Kernels (``csrc/matmul.cu``). f32: the f32 path template
``csrc/gemm_f32_paths.cuh`` (IEEE f32 FMA on the CUDA cores, no TF32),
along the path, block tile and K split that ``plan_f32_gemm`` picks on
the host:
  * ``tile`` (M > 16): a BM x BN block tile (BM 64, 96 or 128; BN 64 or
    128) and K split chosen so that the grid fills the 132 SMs in whole
    waves, up to 8 x 8 outputs a thread, K steps of 32 through a 3-deep
    ring of 16-byte ``cp.async`` copies read back as float4;
  * ``skinny`` (M <= 16: decode, the MoE router): w streamed once in
    16-byte loads, x's rows in shared memory (in gmm's batch, the expert
    on ``blockIdx.z``);
  * K split in units of 16, the partials summed in split order by a
    second kernel, as for bf16 below.
The same template, batched, carries ``winograd_tile_matmul``
(``kernels/conv_winograd.py``), whose short-K stages take a third path,
``stream`` (persistent blocks streaming 128 x 64 items); ``plan_f32_gemm``
plans it with ``batch=16``, and at ``batch=1`` plans as before. So does
the f32 ``gmm_blocks`` (``kernels/gmm.py``, ``batch=E, row_limit=True``:
no stream path, the skinny path at C <= 16), with ``group_sizes`` as each
expert's row limit.
``matmul_packed`` runs on the same template along the plan of the logical
(M,K)x(K,N): each 128-column panel of the packed layout is a row-major
(nK·128, 128) matrix, and no tile or skinny block straddles two panels,
so only the copies' column base changes; a bf16 x is widened to f32 where
it is read back, and the output rounded once. So do
``matmul_dequant_int8`` and ``matmul_dequant_int4`` (``kernels/quant.py``),
with the int8 or packed int4 weight read at its byte count and widened on
chip. bf16 (bf16 out, or f32 out): the tensor-core template
``csrc/gemm_bf16_tc.cuh``, along the path and K split that
``plan_bf16_gemm`` picks on the host:
  * ``tile`` (M > 16): a 64- or 128-row by 128-column block tile of
    ``wgmma.mma_async`` m64n128k16 (one or two warpgroups), fed by a
    3-deep ring of 16-byte ``cp.async`` copies into the 128-byte
    swizzled layout of the wgmma descriptors;
  * ``skinny`` (M <= 16: decode at batch 1-4): each block streams a
    64-column slab of w once and runs ``mma.sync`` m16n8k16 on it, A's
    rows padded to 16 in shared memory only;
  * K is split (in a divisor of its 64-deep steps) when the output tiles
    alone give fewer than 132 blocks; a second kernel sums the f32
    partials in split order, so a shape's result is the same bits on
    every launch. Both launches count as one.
``w`` is read in place either row-major (contiguous) or K-major (a view
whose ``.T`` is contiguous, such as the tied head's ``embed.T``), in f32
and bf16 alike: no copy of the embedding.

Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 989 TFLOP/s
bf16 on them, 3.35 TB/s): max(2·M·N·K / peak, bytes / 3.35e12). The f32
im2col GEMMs of resnet50@224 — (12544,576)x(576,128) and
(3136,1152)x(1152,256), 1.85 GFLOP each — are bound by operations
(≈27.6 µs); the packed head (1,256)x(256,100) by launch latency (its
0.10 MB of f32 panels take 0.03 µs at 3.35 TB/s). The bf16
GEMMs: mamba2-2.7b's (1024,2560)x(2560,5120) prefill projections by
operations (27 µs at the tensor-core rate); every decode projection
(M = 1-4) and the smollm-360m LM head (64,960)x(960,49152) (101 MB, 30 µs)
by reading the weights, which the skinny path streams once.

Training. Under grad (grad mode on and x or w requiring grad) ``matmul``
runs as a ``torch.autograd.Function`` (the counterpart of the jnp products
that ``jax.grad`` differentiates in the JAX package) whose backward is two
more launches of the same kernels: dx = matmul(dy, w.T), where w.T of a
row-major w is K-major and of a K-major w (the tied head's ``embed.T``)
row-major, both read in place; and dw = matmul(x.T.contiguous(), dy), the
one copy (an A operand read in place is later work). Same dtype rules:
bf16 in, f32 accumulator, the gradient in the input's dtype; f32 stays
IEEE. Inference takes the wrapper as before.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — there is no fallback. ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _native

launches = {"matmul": 0, "matmul_bf16": 0, "matmul_packed": 0}
# launches of the bf16 tensor-core kernels (matmul, gmm_blocks and
# gmm_blocks_dw) by path ("tma": gmm_blocks_dw's TMA + wgmma kernel);
# "split" counts the launches of any path that split K
gemm_paths = {"tile": 0, "skinny": 0, "tma": 0, "split": 0}
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# the bf16 template's host planner
# ---------------------------------------------------------------------------
SMS = 132            # streaming multiprocessors of an H100 SXM
SKINNY_MAX_M = 16    # rows of one mma.sync tile
GEMM_BK = 64         # K step of both paths
_PATH_CODE = {"skinny": 0, "tile": 1, "stream": 2}


class GemmPlan(NamedTuple):
    path: str     # "skinny" (M <= 16), "tile", "stream" (f32, batched,
                  # short K) or "tma" (bf16 gmm_blocks_dw, persistent)
    bm: int       # rows a block: 16 (skinny); bf16 tile 64 / 128 (one /
                  # two warpgroups); f32 tile 64, 96 or 128; stream 128
    bn: int       # columns a block: bf16 64 (skinny), 128 (tile); f32 128
                  # or 32 (skinny, row-major / K-major w), 64 or 128
                  # (tile), 64 (stream)
    split: int    # K split, a divisor of ksteps (1: none)
    ksteps: int   # K steps: 64 deep (bf16), 16 deep (f32)
    blocks: int   # blocks of the main launch (stream: persistent blocks)


@functools.lru_cache(maxsize=4096)
def plan_bf16_gemm(M: int, N: int, K: int, batch: int = 1) -> GemmPlan:
    """Path, block tile and K split of the bf16 template for ``batch``
    GEMMs of (M,K)x(K,N). M <= 16 takes the skinny path; otherwise the
    tile path, with 128-row tiles where those alone give at least ``SMS``
    blocks. When the output tiles give fewer than ``SMS`` blocks, K is
    split by the smallest divisor of its steps that reaches ``SMS``
    blocks; where none does (smollm-360m's (64,960)x(960,960): 8 tiles,
    15 steps), by the steps themselves, one a block, as near the card's
    width as the K steps allow."""
    return _plan_bf16(M, N, K, batch, True)


def _plan_bf16(M: int, N: int, K: int, batch: int,
               skinny: bool) -> GemmPlan:
    """``plan_bf16_gemm``; without ``skinny``, the tile path at any M."""
    ksteps = -(-K // GEMM_BK)
    if skinny and M <= SKINNY_MAX_M:
        path, bm, bn = "skinny", SKINNY_MAX_M, 64
    else:
        path, bn = "tile", 128
        big = batch * -(-M // 128) * -(-N // bn)
        bm = 128 if M > 64 and big >= SMS else 64
    tiles = batch * -(-M // bm) * -(-N // bn)
    split = 1
    if tiles < SMS:
        split = next((d for d in range(2, ksteps + 1)
                      if ksteps % d == 0 and tiles * d >= SMS),
                     max(ksteps, 1))
    return GemmPlan(path, bm, bn, split, ksteps, tiles * split)


def count_gemm_path(plan: GemmPlan) -> None:
    """Count a launch along ``plan`` in ``gemm_paths``."""
    with _lock:
        gemm_paths[plan.path] += 1
        if plan.split > 1:
            gemm_paths["split"] += 1


def launch_bf16(kernel: str, fn, plan: GemmPlan, device, out_elems: int,
                *args) -> None:
    """Call ``kernel``'s C entry on the bf16 template, ``fn(*args, path,
    bm, split, scratch, stream)``, with the f32 scratch for the partials
    (``split`` times ``out_elems``) that a split plan needs; count the
    path."""
    scratch = (torch.empty(plan.split * out_elems, dtype=torch.float32,
                           device=device) if plan.split > 1 else None)
    with _native.on_device(device):
        rc = fn(*args, _PATH_CODE[plan.path], plan.bm, plan.split,
                None if scratch is None else scratch.data_ptr(),
                _native.current_stream(device))
    _native.check(rc, kernel)
    count_gemm_path(plan)


def b_layout(w: torch.Tensor) -> Optional[Tuple[bool, int]]:
    """(K-major, leading dimension) of a 2-D ``w`` (K, N) that the matmul
    kernels read in place: row-major when contiguous, K-major when
    ``w.T`` is contiguous; None for any other strides."""
    if w.is_contiguous():
        return False, w.shape[1]
    if w.T.is_contiguous():
        return True, w.shape[0]
    return None


# ---------------------------------------------------------------------------
# the f32 template's host planner
# ---------------------------------------------------------------------------
F32_BK = 16             # K unit of the f32 split (and the skinny path's step)
F32_TILE_BM = (128, 96, 64)   # rows of an f32 tile
F32_TILE_BN = (128, 64)       # columns of an f32 tile
F32_X_FLOATS = 12288    # skinny: floats of x (M rows, a split's k) a block holds
F32_SKINNY_COLS = {False: 128, True: 32}   # columns a block, by K-major w
F32_SKINNY_MIN_STEPS = 4   # fewest K steps a skinny split (where K has them)
F32_STREAM_MAX_K = 64   # stream path: deepest K (a batched GEMM's A streamed)
F32_STREAM_TILE = (128, 64)   # stream path: rows, columns of an item
F32_STREAM_PER_SM = 2   # stream path: persistent blocks an SM


def _f32_skinny_split(tiles: int, ksteps: int, max_steps: int) -> int:
    """The smallest divisor of ``ksteps`` that gives ``tiles`` x split >=
    ``SMS`` blocks with ``F32_SKINNY_MIN_STEPS`` to ``max_steps`` K steps a
    split; where none reaches ``SMS``, the largest such divisor. Splits of
    fewer K steps add more to the partials' sum than their extra blocks
    save (granite's router at one step a split: 0.0050 ms against 0.0042
    at four, CUDA-graph device time on an H100 SXM)."""
    if ksteps == 0:
        return 1
    fits = [d for d in range(1, ksteps + 1)
            if ksteps % d == 0 and ksteps // d <= max_steps]
    long = [d for d in fits if ksteps // d >= F32_SKINNY_MIN_STEPS]
    if not long:        # every split that fits is short: the longest
        return fits[0]
    return next((d for d in long if tiles * d >= SMS), long[-1])


@functools.lru_cache(maxsize=4096)
def plan_f32_gemm(M: int, N: int, K: int, kmajor: bool = False,
                  batch: int = 1, row_limit: bool = False) -> GemmPlan:
    """Path, block tile and K split of the f32 template for ``batch``
    GEMMs of (M,K)x(K,N), from the shapes alone. A batch of GEMMs with K
    <= ``F32_STREAM_MAX_K`` (Winograd's stem and stage 0) takes the stream
    path: ``F32_STREAM_PER_SM`` persistent blocks an SM (fewer where the
    items are fewer) walk the 128 x 64 items, each block a contiguous
    run. At batch 1, M <= 16 takes the skinny path (128 columns a block,
    32 for a K-major w), split as ``_f32_skinny_split`` says within the x
    slice a block holds. ``row_limit`` (the f32 ``gmm_blocks``: a batch
    with a row limit per entry; ``gmm_blocks_dw`` takes the tile plan
    alone) plans without the stream path, which takes none, and takes the
    skinny
    path at M <= 16 at any batch for a row-major w, split over batch x
    column blocks; a K-major w with row limits (``gmm_blocks``' dx)
    takes the tile path at any M. Otherwise the tile
    path over batch x tiles: each
    tile of ``F32_TILE_BM`` x ``F32_TILE_BN`` (BN 128 only where N > 64)
    with no split where its tiles reach ``SMS`` blocks, else with each
    divisor of the K steps that does; of these, the least work on the
    fullest SM (waves x tile x K steps a split), then two blocks an SM
    (they hide each other's latency), then the smaller split, then the
    taller tile. A batched tile plan weighs a block's time by its shared
    loads (a thread reads (BM + BN) / 16 float4 per 4-deep k slice)
    rather than its area: waves x (BM + BN) x K steps a split, which puts
    Winograd's stage 2, (16,784,256)x(16,256,256), on 128 x 128 tiles
    (0.0587 ms of device time against 0.0675 for 64 x 64 on an H100 SXM);
    the batch-1 key stays as it was."""
    ksteps = -(-K // F32_BK)
    if not row_limit and batch > 1 and K <= F32_STREAM_MAX_K and not kmajor:
        bm, bn = F32_STREAM_TILE
        items = batch * -(-M // bm) * -(-N // bn)
        return GemmPlan("stream", bm, bn, 1, ksteps,
                        max(1, min(items, F32_STREAM_PER_SM * SMS)))
    if M <= SKINNY_MAX_M and (batch == 1 or (row_limit and not kmajor)):
        bn = F32_SKINNY_COLS[bool(kmajor)]
        tiles = batch * -(-N // bn)
        split = _f32_skinny_split(tiles, ksteps,
                                  F32_X_FLOATS // (F32_BK * max(M, 1)))
        return GemmPlan("skinny", SKINNY_MAX_M, bn, split, ksteps,
                        tiles * split)
    return _f32_tile_plan(M, N, K, batch)


def _f32_tile_plan(M: int, N: int, K: int, batch: int) -> GemmPlan:
    """``plan_f32_gemm``'s tile plan of ``batch`` (M,K)x(K,N) GEMMs."""
    ksteps = -(-K // F32_BK)
    best = None
    for bn in F32_TILE_BN:
        if bn == 128 and N <= 64:
            continue
        for bm in F32_TILE_BM:
            tiles = batch * -(-M // bm) * -(-N // bn)
            if tiles >= SMS or ksteps <= 1:
                splits = [1]
            else:
                splits = [d for d in range(2, ksteps + 1)
                          if ksteps % d == 0 and tiles * d >= SMS] or [ksteps]
            for d in splits:
                waves = -(-tiles * d // SMS)
                size = bm * bn if batch == 1 else bm + bn
                key = (waves * size * (ksteps // d), abs(waves - 2), d, -bm)
                if best is None or key < best[0]:
                    best = (key, GemmPlan("tile", bm, bn, d, ksteps,
                                          tiles * d))
    return best[1]


# gmm_blocks_dw's TMA + wgmma kernel (csrc/gmm_dw.cu): 128 x 128 output
# tiles, stages of 64 token rows, the group sizes of at most 1024 experts
# held in shared memory
DW_TMA_TILE = 128
DW_TMA_BK = 64
DW_TMA_MAX_E = 1024


def plan_gmm_dw(d: int, n: int, C: int, E: int, dtype: torch.dtype,
                aligned: bool = True) -> GemmPlan:
    """The route and tiles of ``gmm_blocks_dw`` for E experts' (d, C)x(C,
    n) products, from the shapes and whether both operands' bases lie on
    16 bytes (``aligned``). bf16 with d and n multiples of 8 (TMA's 16-byte
    strides), aligned bases and at most ``DW_TMA_MAX_E`` experts: "tma",
    ``DW_TMA_TILE`` x ``DW_TMA_TILE`` tiles walked by ``min(tiles, SMS)``
    persistent blocks (``ksteps`` of ``DW_TMA_BK`` rows, no split). Any
    other bf16 shape: the tile path at ``plan_bf16_gemm``'s tiles and split
    (its A read M-major; the skinny path takes no M-major A). f32:
    ``plan_f32_gemm``'s tile plan."""
    if dtype == torch.float32:
        return _f32_tile_plan(d, n, C, E)
    if aligned and d % 8 == 0 and n % 8 == 0 and E <= DW_TMA_MAX_E:
        tiles = E * -(-d // DW_TMA_TILE) * -(-n // DW_TMA_TILE)
        return GemmPlan("tma", DW_TMA_TILE, DW_TMA_TILE, 1,
                        -(-C // DW_TMA_BK), max(1, min(tiles, SMS)))
    return _plan_bf16(d, n, C, E, False)


def launch_f32(kernel: str, fn, plan: GemmPlan, device, out_elems: int,
               *args) -> None:
    """Call ``kernel``'s C entry on the f32 path template, ``fn(*args,
    path, bm, bn, split, scratch, stream)``, with the f32 scratch for the
    partials (``split`` times ``out_elems``) that a split plan needs."""
    scratch = (torch.empty(plan.split * out_elems, dtype=torch.float32,
                           device=device) if plan.split > 1 else None)
    with _native.on_device(device):
        rc = fn(*args, _PATH_CODE[plan.path], plan.bm, plan.bn, plan.split,
                None if scratch is None else scratch.data_ptr(),
                _native.current_stream(device))
    _native.check(rc, kernel)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------
def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """f32-accumulated x @ w, cast to ``out_dtype`` (default x's dtype;
    ``matmul_ref``)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(
        out_dtype or x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) (float32 or bfloat16; w the same) in
    ``out_dtype``: x's dtype by default, or float32 for bf16 inputs. ``w``
    is contiguous or K-major (``w.T`` contiguous, read in place). Under
    grad, the autograd Function whose backward runs the same kernels."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Matmul.apply(x, w, out_dtype)
    return _matmul(x, w, out_dtype)


class _Matmul(torch.autograd.Function):
    """``matmul`` under autograd: dx = matmul(dy, w.T) (w read in place,
    K-major or row-major), dw = matmul(x.T.contiguous(), dy); dy is taken
    in x's dtype (a bf16 product with f32 out hands back an f32 dy)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _matmul(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = _matmul(dy, w.T) if ctx.needs_input_grad[0] else None
        dw = (_matmul(x.T.contiguous(), dy) if ctx.needs_input_grad[1]
              else None)
        return dx, dw, None


def matmul_cost(out, x, w, out_dtype=None) -> Tuple[float, float]:
    """2·M·N·K; x and w read once, the output written once."""
    M, K = x.shape
    N = w.shape[1]
    return (2 * M * N * K, x.element_size() * M * K
            + w.element_size() * K * N + out.element_size() * M * N)


@_native.costed("matmul", matmul_cost)
def _matmul(x: torch.Tensor, w: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(x.shape)} x {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"matmul: no {out_dtype} output for {x.dtype} inputs")
    # any other strides reach on_cpu as they are: fine on the CPU, refused
    # (not contiguous) on the card
    kmajor, ldb = b_layout(w) or (False, 0)
    if _native.on_cpu("matmul", x, w.T if kmajor else w,
                      dtypes=(torch.float32, torch.bfloat16), meta=True):
        return matmul_plain(x, w, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M and N and not x.is_meta:
        lib = _native.library("matmul")
        if x.dtype == torch.bfloat16:
            fn = (lib.repro_matmul_bf16_f32out if out_dtype == torch.float32
                  else lib.repro_matmul_bf16)
            launch_bf16("matmul", fn, plan_bf16_gemm(M, N, K), x.device,
                        M * N,
                        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                        ldb, int(kmajor))
            _count("matmul_bf16")
        else:
            launch_f32("matmul", lib.repro_matmul_f32,
                       plan_f32_gemm(M, N, K, kmajor), x.device, M * N,
                       x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                       ldb, int(kmajor))
            _count("matmul")
    return out


# ---------------------------------------------------------------------------
# matmul_packed
# ---------------------------------------------------------------------------
def matmul_packed_plain(x: torch.Tensor, w_packed: torch.Tensor,
                        K: int, N: int) -> torch.Tensor:
    """Blocked contraction over the packed layout, with the Pallas
    wrapper's padding: x's K is zero-padded to nK·bk, the result is cut to
    [:M, :N]."""
    nN, nK, bk, bn = w_packed.shape
    M = x.shape[0]
    Kp = nK * bk
    if x.shape[1] != Kp:
        x = F.pad(x, (0, Kp - x.shape[1]))
    xb = x.to(torch.float32).reshape(M, nK, bk)
    y = torch.einsum("mkc,nkcd->mnd", xb, w_packed.to(torch.float32))
    return y.reshape(M, nN * bn)[:, :N].to(x.dtype)


def matmul_packed(x: torch.Tensor, w_packed: torch.Tensor,
                  K: int, N: int) -> torch.Tensor:
    """x: (M, K) float32 or bfloat16; w_packed: (N/bn, K/bk, bk, bn)
    float32 from LinearPacked -> (M, N) in x's dtype. On the card the
    kernel runs along ``plan_f32_gemm(M, N, K)``."""
    if x.dim() != 2 or w_packed.dim() != 4:
        raise ValueError("matmul_packed: x must be (M, K) and w_packed 4-d")
    nN, nK, bk, bn = w_packed.shape
    if x.shape[1] != K or K > nK * bk or N > nN * bn:
        raise ValueError(f"matmul_packed: x {tuple(x.shape)} does not fit "
                         f"K={K}, N={N}, packed {tuple(w_packed.shape)}")
    if _native.on_cpu("matmul_packed", x, w_packed,
                      each=((torch.float32, torch.bfloat16),
                            (torch.float32,))):
        return matmul_packed_plain(x, w_packed, K, N)
    if bk != 128 or bn != 128:
        raise ValueError("matmul_packed: the CUDA kernel takes 128x128 tiles")
    M = x.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        lib = _native.library("matmul")
        fn = (lib.repro_matmul_packed_bf16 if x.dtype == torch.bfloat16
              else lib.repro_matmul_packed_f32)
        launch_f32("matmul_packed", fn, plan_f32_gemm(M, N, K), x.device,
                   M * N, x.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
                   M, N, K, nK)
        _count("matmul_packed")
    return out
