"""Mamba2 SSD chunked scan for Hopper — the port of ``repro/kernels/ssd.py``
(``ssd_scan``, ``_ssd_kernel``), extended to what ``models.ssm.ssd_chunked``
computes: an optional initial state and the final state.

x (B, S, H, P) and Bm, Cm (B, S, N) (G = 1: one B and C for every head) in
float32 or bfloat16; dt (B, S, H) after the softplus, A (H,) negative,
D (H,), and the states (B, H, P, N) in float32. S is a multiple of the
chunk Q. Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
float32), the layout ``ssd_chunked`` returns (the Pallas kernel keeps its
state as (N, P) and returns y only, from a zero state).

Kernel: ``csrc/ssd.cu``, the chunked SSD algorithm as Mamba2's GPU code
splits it (arXiv:2405.21060, "SSD algorithm"), in four phases that are
parallel over chunks wherever the algebra allows; ``ssd_scan_plain`` runs
the same four phases as tensor code:

1. ``ssd_cum_cb``, per (b, chunk): ``cum`` (B, nc, H, Q), the
   within-chunk cumulative sum of dt·A of every head, and ``CB`` (B, nc,
   Q, Q) = C·Bᵀ in f32, computed once for all heads (G = 1); the kernel
   computes its 64-row tiles on and below the diagonal only.
2. ``ssd_chunk_states``, per (b, chunk, h): s_c = Σ_j exp(cum_last −
   cum_j)·dt_j·B_jᵀ x_j, (N, P) in f32.
3. ``ssd_state_passing``, per (b, h): in_0 = init (or zero), in_{c+1} =
   exp(cum_last,c)·in_c + s_c, one fused multiply-add an element and
   chunk in chunk order; the final state is in_nc.
4. ``ssd_chunk_output``, per (b, chunk, h, 64-row tile, heaviest first):
   y_i = Σ_{j≤i} (CB_ij·exp(cum_i − cum_j)·dt_j)·x_j + exp(cum_i)·C_i·in_c
   + D·x_i, exp taken only where j ≤ i.

The wrapper allocates ``cum``, ``CB`` and the chunk states with
``torch.empty`` (0.3, 1 and 10.5 MB at mamba2-2.7b's B 1, S 1024: they
stay in the 50 MB L2); the kernels allocate nothing and never sync with
the host. ``plan_ssd`` gives, from the shapes alone, the blocks of each
phase (one cut for every shape, so a forward can be captured in a CUDA
graph). The f32 path runs every product as an IEEE f32 FMA on the CUDA
cores (no TF32). The bf16 path runs every product on the tensor cores
(``mma.sync``, f32 accumulators): C·Bᵀ directly, the products with an
f32 operand v (w·x, the carried state, G) as v = hi + lo, two bf16 values
and two products, exact but for about 2^-17 of v. The carried state is
stored in f32 only, never rounded to bf16. No atomics and a fixed order
for every sum: two launches on the same inputs give the same bits. P <=
64, N <= 128; ragged P, N and Q are masked in the kernels; a larger P or
N raises ``ValueError``.

Bound on an H100 SXM: mamba2-2.7b (H 80, P 64, N 128, Q 256) at S 1024
needs 4.07 GFLOP over the chunks' lower triangles, C·Bᵀ counted once per
(b, chunk), and moves about 24 MB. In f32 on the CUDA cores that is 0.061
ms of operations (67 TFLOP/s); in bf16 the bytes bound it (0.0072 ms at
3.35 TB/s, the operations 0.0041 ms at the 989 TFLOP/s tensor-core peak).
What keeps the bf16 path above that is traffic through L2 (every head's
blocks reread the chunk's f32 C·Bᵀ and the carried state) and the
latency of the fills; left for later: TMA rings that overlap a stage's
fill with the last stage's products, and C·Bᵀ read once for several
heads.

Backward: under grad (grad mode on, an input requiring grad) ``ssd_scan``
is the autograd Function ``_SsdScan``. Its forward keeps the kernels' cum,
CB and chunk-state buffer (which holds the chunk-entry states once phase 3
has run) and saves them with the inputs; its backward is
``ssd_scan_bwd`` (``csrc/ssd_bwd.cu``), the four phases in reverse with
nothing recomputed: 4′ (the chunk's own and off-diagonal terms, D), 3′
(the state gradient carried back over the chunks, giving the gradient of
the initial state), 2′ (the chunk states' terms), 1′ (C·Bᵀ and the
within-chunk cumulative sum). The reference has no twin: it trains by
``jax.grad`` of its jnp ``ssd_chunked``. ``ssd_scan_bwd_plain`` runs the
same phases as tensor code by the explicit formulas (not autograd), in
f32. The kernels' chunk kernel takes one block a (b, chunk, 64-row tile,
group of heads) and sums the group's terms of dB, dC and dCB on chip, in
head order; ``plan_ssd_bwd`` picks the group from the shapes. bf16 runs
the products on the tensor cores (the forward's hi + lo split of an f32
operand), f32 on the CUDA cores in IEEE f32. No atomics: two launches
give the same bits. At mamba2-2.7b's training microbatch (B 4, S 512) it
needs ~16 GFLOP and moves ~100 MB: 0.242 ms at the f32 peak, 0.030 ms of
bytes.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise — there is no fallback. ``launches`` counts
one per wrapper call that launches the phases (``ssd_scan``: four
kernels; ``ssd_scan_bwd``: five).
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _native

launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}
_lock = threading.Lock()

SSD_MAX_P = 64           # largest head dim the kernels take
SSD_MAX_N = 128          # largest state dim
SSD_TILE = 64            # rows of a C·Bᵀ or output tile; depth of a stage
_HEADS_A_CUM_BLOCK = 4   # phase 1: one warp a head
_PASS_COLS = 32          # phase 3: state rows (n) a block


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


# ---------------------------------------------------------------------------
# the plain version, in the kernels' four phases
# ---------------------------------------------------------------------------
def ssd_cum_cb(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: ``cum`` (B, nc, H, Q), the within-chunk cumulative sum of
    dt·A, and ``CB`` (B, nc, Q, Q) = C·Bᵀ of each chunk in f32, once for
    every head (G = 1)."""
    f32 = torch.float32
    B, S, H = dt.shape
    N, Q = Bm.shape[-1], chunk
    nc = S // Q
    a = dt.reshape(B, nc, Q, H).to(f32) * A.to(f32)
    cum = torch.cumsum(a, dim=2).transpose(2, 3)
    Cc = Cm.reshape(B, nc, Q, N).to(f32)
    Bc = Bm.reshape(B, nc, Q, N).to(f32)
    return cum, Cc @ Bc.transpose(-1, -2)


def ssd_chunk_states(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                     cum: torch.Tensor) -> torch.Tensor:
    """Phase 2: each chunk's own state (B, nc, H, N, P), s_c = Σ_j
    exp(cum_last − cum_j)·dt_j·B_jᵀ x_j."""
    f32 = torch.float32
    B, nc, H, Q = cum.shape
    P, N = x.shape[-1], Bm.shape[-1]
    dtc = dt.reshape(B, nc, Q, H).to(f32).transpose(2, 3)        # (B,nc,H,Q)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    return torch.einsum("bcjn,bchj,bcjhp->bchnp",
                        Bm.reshape(B, nc, Q, N).to(f32), w,
                        x.reshape(B, nc, Q, H, P).to(f32))


def ssd_state_passing(states: torch.Tensor, cum: torch.Tensor,
                      init_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 3: the state entering each chunk (B, nc, H, N, P), in_0 =
    init (or zero) and in_{c+1} = exp(cum_last,c)·in_c + s_c, and the final
    state in_nc as (B, H, P, N)."""
    B, nc, H, N, P = states.shape
    cur = (torch.zeros((B, H, N, P), dtype=torch.float32,
                       device=states.device) if init_state is None
           else init_state.to(torch.float32).transpose(-1, -2))
    decay = torch.exp(cum[..., -1])                              # (B,nc,H)
    ins = []
    for c in range(nc):
        ins.append(cur)
        cur = cur * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(ins, dim=1), cur.transpose(-1, -2)


def ssd_chunk_output(x: torch.Tensor, dt: torch.Tensor, Cm: torch.Tensor,
                     D: torch.Tensor, cum: torch.Tensor, CB: torch.Tensor,
                     ins: torch.Tensor) -> torch.Tensor:
    """Phase 4: y (B, S, H, P) in x's dtype, y_i = Σ_{j≤i} (CB_ij·exp(cum_i
    − cum_j)·dt_j)·x_j + exp(cum_i)·C_i·in_c + D·x_i."""
    f32 = torch.float32
    B, nc, H, Q = cum.shape
    S, P, N = x.shape[1], x.shape[-1], Cm.shape[-1]
    xc = x.reshape(B, nc, Q, H, P).to(f32)
    dtc = dt.reshape(B, nc, Q, H).to(f32).transpose(2, 3)        # (B,nc,H,Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # exp(cum_i - cum_j) for j <= i only: above the diagonal it may be inf.
    # The exponent is masked first, so autograd through this version (the
    # reference of the backward on the card) never differentiates an inf
    # (0·inf); the values are the same
    zero = torch.zeros((), dtype=f32, device=x.device)
    L = torch.where(tri, torch.exp(torch.where(
        tri, cum[..., :, None] - cum[..., None, :], zero)), zero)
    G = CB[:, :, None] * L * dtc[..., None, :]                   # (B,nc,H,i,j)
    y = torch.einsum("bchij,bcjhp->bcihp", G, xc)
    y_off = torch.einsum("bcin,bchnp->bcihp",
                         Cm.reshape(B, nc, Q, N).to(f32), ins)
    y = y + y_off * torch.exp(cum).transpose(2, 3)[..., None]
    y = y.reshape(B, S, H, P) + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   chunk: int, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked``'s arithmetic with G = 1 in f32, as the kernels'
    four phases."""
    _check(x, dt, A, Bm, Cm, D, chunk, init_state)
    cum, CB = ssd_cum_cb(dt, A, Bm, Cm, chunk)
    states = ssd_chunk_states(x, dt, Bm, cum)
    ins, final = ssd_state_passing(states, cum, init_state)
    return ssd_chunk_output(x, dt, Cm, D, cum, CB, ins), final


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
class SsdPlan(NamedTuple):
    blocks: Tuple[int, int, int, int]  # blocks of phases 1-4


@functools.lru_cache(maxsize=1024)
def plan_ssd(B: int, S: int, H: int, P: int, N: int, Q: int,
             dtype: torch.dtype = torch.float32) -> SsdPlan:
    """How ``ssd_scan``'s kernels cut (B, S, H, P, N, Q), from the shapes
    alone (so a forward can be captured in a CUDA graph): the blocks each
    phase launches, in either dtype. The cut is one for every shape, the
    fastest of those timed on the card (``PERF.md`` §6): phase 2
    takes 64 state rows a block (128 lost at B 1 and tied at B 4, in
    f32); phase 4 takes 64-row tiles launched heaviest first (32-row
    tiles lost at 80 heads and at 8, the natural order was no faster); P
    is never split (a block's C and x tiles serve every column of y);
    phase 3 stays a kernel of its own (folded into phase 4's fill of the
    state it lost at 2 and 4 chunks). Raises ``ValueError`` for P > 64,
    N > 128 or S not a multiple of Q, which the kernels refuse."""
    if not (1 <= P <= SSD_MAX_P and 1 <= N <= SSD_MAX_N):
        raise ValueError(f"ssd_scan: the kernels take P <= {SSD_MAX_P} and "
                         f"N <= {SSD_MAX_N}, got P={P}, N={N}")
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of chunk={Q}")
    nc, t = S // Q, -(-Q // SSD_TILE)
    heads = B * nc * H
    return SsdPlan((B * nc * (t * (t + 1) // 2 + -(-H // _HEADS_A_CUM_BLOCK)),
                    heads * -(-N // SSD_TILE),
                    B * H * -(-N // _PASS_COLS),
                    heads * t))


# the backward's chunk kernel: one block a (b, chunk, 64-row tile, group of
# heads). Its shared memory mirrors csrc/ssd_bwd.cu's ChunkSmem<T>::bytes:
# the fixed tiles (ChunkSmem<T>::kFixed), up to SSD_BWD_HELD row tiles of
# dCB terms (kSmemTiles), and per row of the chunk (2 kBufs + 1) floats
# (f32: three; bf16: five, cum and dt doubled)
SSD_BWD_HELD = 4                            # kSmemTiles
SSD_BWD_MAX_SMEM = 232448                   # kMaxSmem: an H100 block's
_SMS = 132                                  # an H100's SMs
_BWD_FIXED_SMEM = {torch.float32: 147456,   # ChunkSmem<T>::kFixed
                   torch.bfloat16: 151040}
_BWD_PASS_ROWS = 32                         # kPassRows: the pass kernel's


class SsdBwdPlan(NamedTuple):
    heads: int        # heads a chunk block walks, in order (its group)
    groups: int       # ceil(H / heads): partial sums of dB, dC and dCB
    blocks: Tuple[int, int, int, int, int]  # din, pass, chunk, bc, scan
    smem: int         # the chunk kernel's dynamic shared memory, bytes
    scratch: int      # bytes of scratch the wrapper allocates


def ssd_bwd_plan(B: int, S: int, H: int, P: int, N: int, Q: int,
                 dtype: torch.dtype, heads: int) -> SsdBwdPlan:
    """``ssd_scan_bwd``'s cut of (B, S, H, P, N, Q) with chunk blocks of
    ``heads`` heads (``plan_ssd_bwd`` picks them). Raises ``ValueError``
    for what the kernels refuse: P > 64, N > 128, S not a multiple of Q,
    or a chunk whose rows need more shared memory than a block has."""
    plan_ssd(B, S, H, P, N, Q, dtype)
    nc, t = S // Q, -(-Q // SSD_TILE)
    smem = (_BWD_FIXED_SMEM[dtype] + min(t, SSD_BWD_HELD) * SSD_TILE ** 2 * 4
            + (20 if dtype == torch.bfloat16 else 12) * Q)
    if smem > SSD_BWD_MAX_SMEM:
        raise ValueError(f"ssd_scan_bwd: chunk={Q} needs {smem} bytes of "
                         f"shared memory a block, more than "
                         f"{SSD_BWD_MAX_SMEM}")
    heads = max(1, min(heads, H))
    groups = -(-H // heads)
    n64, n32 = -(-N // SSD_TILE), -(-N // _BWD_PASS_ROWS)
    floats = (B * nc * H * N * P * (2 if dtype == torch.bfloat16 else 1)
              + B * nc * H * n32 + 2 * groups * B * S * N
              + groups * B * nc * Q * Q + B * nc * H * t * (Q + 1))
    return SsdBwdPlan(heads, groups,
                      (H * B * nc * n64, n32 * B * H, groups * B * nc * t,
                       t * B * nc * 2 * n64, H),
                      smem, 4 * floats)


@functools.lru_cache(maxsize=1024)
def plan_ssd_bwd(B: int, S: int, H: int, P: int, N: int, Q: int,
                 dtype: torch.dtype = torch.float32) -> SsdBwdPlan:
    """How ``ssd_scan_bwd``'s kernels cut (B, S, H, P, N, Q), from the
    shapes alone (so a backward can be captured in a CUDA graph): the chunk
    kernel's group of heads, the fewest that keep its grid within two waves
    of one block an SM (its shared memory) on the 132 SMs. Fewer heads a
    block mean more blocks to balance the heavy first row tiles against the
    light last ones, but more per-block work and more partial sums of dB,
    dC and dCB; on an H100 the group at two waves was the fastest timed, and
    one head fewer (a third wave begun) ran 25 % slower (``PERF.md`` §6).
    Raises as ``ssd_bwd_plan`` does."""
    plan_ssd(B, S, H, P, N, Q, dtype)
    groups = max(1, min(H, 2 * _SMS // (B * (S // Q) * -(-Q // SSD_TILE))))
    heads = -(-H // groups)
    return ssd_bwd_plan(B, S, H, P, N, Q, dtype, heads)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def ssd_cost(out, x, dt, A, Bm, Cm, D, chunk, init_state,
             keep) -> Tuple[float, float]:
    """The products over each chunk's lower triangle: C·Bᵀ once a (b,
    chunk) (every head shares B and C), a head's product with x on those
    pairs, C·state and the state update on Q x N x P; x, dt, A, Bm, Cm,
    D (and the initial state) read once, y and the final state (and the
    kept cum, CB and chunk-entry states) written once."""
    B, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc, pairs = S // Q, Q * (Q + 1) // 2
    es = x.element_size()
    nbytes = (es * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (B * S * H + 2 * H)
              + 4 * B * H * P * N * (1 + int(init_state is not None)))
    if keep:
        nbytes += 4 * (B * S * H + B * nc * Q * Q + B * nc * H * N * P)
    return (2 * B * nc * pairs * N
            + 2 * B * H * nc * (pairs * P + 2 * Q * N * P)), nbytes


def ssd_bwd_cost(out, x, dt, A, Bm, Cm, D, cum, CB, ins, dy,
                 dfinal=None) -> Tuple[float, float]:
    """d in_c, the chunk products (4 off the diagonal and 2 on it, Q x N x
    P a head and chunk), dy_i·x_j and dx on the lower triangle's pairs, dC
    and dB from dCB once a (b, chunk); each input read once (CB's lower
    triangle), each output written once."""
    B, S, H, P = x.shape
    N, nc, Q = Bm.shape[-1], cum.shape[1], cum.shape[3]
    pairs = Q * (Q + 1) // 2
    es = x.element_size()
    flops = (2 * B * nc * H * (4 * Q * N * P + 2 * pairs * P)
             + 4 * B * nc * pairs * N)
    nbytes = (es * (3 * B * S * H * P + 4 * B * S * N)
              + 4 * (3 * B * S * H + 4 * H + B * nc * pairs)
              + 4 * B * nc * H * N * P
              + 4 * B * H * P * N * (1 + int(dfinal is not None)))
    return flops, nbytes


@_native.costed("ssd_scan", ssd_cost)
def _ssd_forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 chunk: int, init_state: Optional[torch.Tensor], keep: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[Tuple[torch.Tensor, ...]]]:
    """(y, final state, (cum, CB, ins) where ``keep`` else None): the
    kernels (or, on the CPU, the plain version's phases). After phase 3
    the kernels' chunk-state buffer holds the states entering the chunks,
    ``ins`` (B, nc, H, N, P): ``ssd_scan_bwd`` reads the three buffers and
    recomputes nothing."""
    _check(x, dt, A, Bm, Cm, D, chunk, init_state)
    f32 = torch.float32
    ts = [x, dt, A, Bm, Cm, D] + ([] if init_state is None else [init_state])
    io = (torch.float32, torch.bfloat16)
    if _native.on_cpu("ssd_scan", *ts,
                      each=[io, (f32,), (f32,), (x.dtype,), (x.dtype,),
                            (f32,), (f32,)][:len(ts)], meta=True):
        cum, CB = ssd_cum_cb(dt, A, Bm, Cm, chunk)
        states = ssd_chunk_states(x, dt, Bm, cum)
        ins, final = ssd_state_passing(states, cum, init_state)
        y = ssd_chunk_output(x, dt, Cm, D, cum, CB, ins)
        return y, final, ((cum, CB, ins) if keep else None)
    B, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    plan_ssd(B, S, H, P, N, Q, x.dtype)  # refuses what the kernels do not take
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    nc = S // Q
    cum = torch.empty((B, nc, H, Q), dtype=f32, device=x.device)
    cb = torch.empty((B, nc, Q, Q), dtype=f32, device=x.device)
    states = torch.empty((B, nc, H, N, P), dtype=f32, device=x.device)
    if x.is_meta:
        pass  # the dry run: the outputs' shapes, no launch
    elif B and S and H:
        lib = _native.library("ssd")
        fn = (lib.repro_ssd_scan_bf16 if x.dtype == torch.bfloat16
              else lib.repro_ssd_scan_f32)
        with _native.on_device(x.device):
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), D.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), final.data_ptr(), cum.data_ptr(),
                    cb.data_ptr(), states.data_ptr(), B, S, H, P, N, Q,
                    _native.current_stream(x.device))
        _native.check(rc, "ssd_scan")
        with _lock:
            launches["ssd_scan"] += 1
    elif init_state is not None:
        final.copy_(init_state)
    else:
        final.zero_()
    return y, final, ((cum, cb, states) if keep else None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan; returns (y, final_state (B,H,P,N) f32). Under
    grad (grad mode on and an input requiring grad) the autograd Function
    whose backward is ``ssd_scan_bwd``."""
    ins = (x, dt, A, Bm, Cm, D, init_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return _SsdScan.apply(*ins, chunk)
    return _ssd_forward(x, dt, A, Bm, Cm, D, chunk, init_state, False)[:2]


class _SsdScan(torch.autograd.Function):
    """``ssd_scan`` under autograd: the forward keeps the kernels' cum, CB
    and chunk-entry states, the backward is the ``ssd_scan_bwd`` kernel
    (its plain version on CPU tensors). An unused final state's gradient
    stays None (no zero-filled tensor) and is read as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, chunk):
        y, final, (cum, cb, ins) = _ssd_forward(x, dt, A, Bm, Cm, D, chunk,
                                                init_state, True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, cum, cb, ins)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D, cum, cb, ins = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, D, cum, cb, ins,
                             dy.contiguous(),
                             None if dfinal is None else dfinal.contiguous())
        dinit = grads[-1] if ctx.needs_input_grad[6] else None
        return (*grads[:-1], dinit, None)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
def _check_bwd(x, dt, A, Bm, Cm, D, cum, CB, ins, dy, dfinal) -> None:
    _check(x, dt, A, Bm, Cm, D, 1, None)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc, Q = (cum.shape[1], cum.shape[3]) if cum.dim() == 4 else (-1, -1)
    if (nc * Q != S or tuple(cum.shape) != (B, nc, H, Q)
            or tuple(CB.shape) != (B, nc, Q, Q)
            or tuple(ins.shape) != (B, nc, H, N, P)
            or tuple(dy.shape) != tuple(x.shape)
            or (dfinal is not None
                and tuple(dfinal.shape) != (B, H, P, N))):
        raise ValueError(
            f"ssd_scan_bwd: the forward's buffers do not fit x "
            f"{tuple(x.shape)}: cum {tuple(cum.shape)}, CB "
            f"{tuple(CB.shape)}, ins {tuple(ins.shape)}, dy "
            f"{tuple(dy.shape)}, d final "
            f"{None if dfinal is None else tuple(dfinal.shape)}")


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                       cum: torch.Tensor, CB: torch.Tensor, ins: torch.Tensor,
                       dy: torch.Tensor,
                       dfinal: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dBm, dCm, dD, d init) of ``ssd_scan`` by the explicit
    formulas, in f32, in the forward's four phases reversed (4, 3, 2, 1);
    dx, dBm and dCm in their inputs' dtype, the rest f32. Reads the
    forward's ``cum``, ``CB`` (only on and below each chunk's diagonal)
    and chunk-entry states ``ins``; ``dfinal`` None is a zero gradient of
    the final state. With L_ij = exp(cum_i − cum_j) for j ≤ i (else 0,
    taken nowhere above the diagonal) and G_ij = CB_ij·L_ij·dt_j:

    4′ dx_j = Σ_i G_ij dy_i + D dy_j; dCB_ij = Σ_h L_ij dt_j (dy_i·x_j);
       ddt_j = Σ_i CB_ij L_ij (dy_i·x_j); dcum takes M_ij = G_ij (dy_i·x_j)
       at i and −M_ij at j; d in_c = Σ_i exp(cum_i) C_iᵀ dy_i; dC_i = Σ_h
       exp(cum_i) in_c dy_i, and dcum_i the same dotted with C_i.
    3′ g = d final; for c = nc−1 … 0: ds_c = g, dcum_last,c +=
       exp(cum_last,c)⟨in_c, g⟩, g = exp(cum_last,c) g + d in_c; d init = g.
    2′ w_j = exp(cum_last − cum_j) dt_j: dx_j += w_j B_j ds_c, dB_j = Σ_h
       w_j ds_c x_j; dw_j = B_j ds_c x_j gives ddt_j exp(cum_last − cum_j)
       dw_j, dcum_j −w_j dw_j and dcum_last Σ_j w_j dw_j.
    1′ dC += dCB B, dB += dCBᵀ C; da = the reverse cumulative sum of dcum
       in the chunk; ddt += da A, dA = Σ da dt.

    Nothing divides by CB or dt: a zero dt gives no NaN."""
    _check_bwd(x, dt, A, Bm, Cm, D, cum, CB, ins, dy, dfinal)
    f32 = torch.float32
    B, S, H, P = x.shape
    N, (nc, Q) = Bm.shape[-1], (cum.shape[1], cum.shape[3])
    dev = x.device
    xc = x.reshape(B, nc, Q, H, P).to(f32)
    dyc = dy.reshape(B, nc, Q, H, P).to(f32)
    dtc = dt.reshape(B, nc, Q, H).to(f32).transpose(2, 3)        # (B,nc,H,Q)
    Bc = Bm.reshape(B, nc, Q, N).to(f32)
    Cc = Cm.reshape(B, nc, Q, N).to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    cb = torch.where(tri, CB, zero)     # the kernels write no upper tiles
    # 4': the chunk's own terms
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    zero)                                       # (B,nc,H,i,j)
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)            # dy_i·x_j
    Ld = L * dtc[..., None, :]
    dcb = (Ld * dyx).sum(2)                                      # (B,nc,i,j)
    td = cb[:, :, None] * L * dyx          # CB_ij L_ij (dy_i·x_j): ddt's term
    dxc = torch.einsum("bchij,bcihp->bcjhp", cb[:, :, None] * Ld, dyc)
    ddt = td.sum(3)                                              # (B,nc,H,Q)
    m = td * dtc[..., None, :]
    dcum = m.sum(4) - m.sum(3)
    ecum = torch.exp(cum)
    dyin = torch.einsum("bcihp,bchnp->bchin", dyc, ins)          # in_c dy_i
    dCc = torch.einsum("bchi,bchin->bcin", ecum, dyin)
    dcum = dcum + ecum * torch.einsum("bcin,bchin->bchi", Cc, dyin)
    din = torch.einsum("bchi,bcin,bcihp->bchnp", ecum, Cc, dyc)
    dxc = dxc + dyc * D.to(f32)[:, None]
    dD = (dyc * xc).sum((0, 1, 2, 4))
    # 3': the state gradient carried back over the chunks
    g = (torch.zeros((B, H, N, P), dtype=f32, device=dev) if dfinal is None
         else dfinal.to(f32).transpose(-1, -2))
    decay = torch.exp(cum[..., -1])                              # (B,nc,H)
    ds, dlast = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        ds[c] = g
        dlast[c] = decay[:, c] * (ins[:, c] * g).sum((-1, -2))
        g = decay[:, c, :, None, None] * g + din[:, c]
    dinit = g.transpose(-1, -2).contiguous()
    ds = torch.stack(ds, 1)                                      # (B,nc,H,N,P)
    # 2': the chunk states' terms
    eout = torch.exp(cum[..., -1:] - cum)
    w = eout * dtc
    u = torch.einsum("bcjn,bchnp->bcjhp", Bc, ds)                # B_j ds_c
    dxc = dxc + u * w.transpose(2, 3)[..., None]
    dBc = torch.einsum("bchj,bchnp,bcjhp->bcjn", w, ds, xc)
    dw = torch.einsum("bcjhp,bcjhp->bchj", u, xc)
    ddt = ddt + eout * dw
    wdw = w * dw
    dcum = dcum - wdw
    dcum[..., -1] += wdw.sum(-1) + torch.stack(dlast, 1)
    # 1': C·Bᵀ and the cumulative sum
    dCc = dCc + dcb @ Bc
    dBc = dBc + dcb.transpose(-1, -2) @ Cc
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + da * A.to(f32)[:, None]
    dA = (da * dtc).sum((0, 1, 3))
    return (dxc.reshape(B, S, H, P).to(x.dtype),
            ddt.transpose(2, 3).reshape(B, S, H),
            dA, dBc.reshape(B, S, N).to(Bm.dtype),
            dCc.reshape(B, S, N).to(Cm.dtype), dD, dinit)


@_native.costed("ssd_scan_bwd", ssd_bwd_cost)
def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 cum: torch.Tensor, CB: torch.Tensor, ins: torch.Tensor,
                 dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dBm, dCm, dD, d init) of ``ssd_scan`` given the
    forward's ``cum``, ``CB``, ``ins`` and the gradients of y and of the
    final state (None: zero): the ``csrc/ssd_bwd.cu`` kernels along
    ``plan_ssd_bwd`` on CUDA tensors (five launches counted as one), the
    plain version on CPU tensors."""
    _check_bwd(x, dt, A, Bm, Cm, D, cum, CB, ins, dy, dfinal)
    f32 = torch.float32
    ts = [x, dt, A, Bm, Cm, D, cum, CB, ins, dy] + (
        [] if dfinal is None else [dfinal])
    io = (torch.float32, torch.bfloat16)
    if _native.on_cpu("ssd_scan_bwd", *ts,
                      each=[io, (f32,), (f32,), (x.dtype,), (x.dtype,),
                            (f32,), (f32,), (f32,), (f32,), (x.dtype,),
                            (f32,)][:len(ts)], meta=True):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, cum, CB, ins, dy,
                                  dfinal)
    B, S, H, P = x.shape
    N, nc = Bm.shape[-1], cum.shape[1]
    Q = cum.shape[3]
    plan = plan_ssd_bwd(B, S, H, P, N, Q, x.dtype)
    dev = x.device
    dx, dBm, dCm = (torch.empty_like(x), torch.empty_like(Bm),
                    torch.empty_like(Cm))
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dD = torch.empty((H,), dtype=f32, device=dev)
    dinit = torch.empty((B, H, P, N), dtype=f32, device=dev)
    if x.is_meta:
        pass  # the dry run: the outputs' shapes, no launch
    elif B and S and H:
        # scratch: d in_c, then ds_c in place (B,nc,H,N,P; bf16: ds_c as
        # its hi + lo bf16 halves in the same bytes); the pass's row
        # blocks' terms of <in_c, g> (B,nc,H,ceil(N/32)); each head group's
        # sums of dB and dC (2,G,B,S,N) and of dCB (G,B,nc,Q,Q); each head's
        # and tile's dcum terms (B,nc,H,tiles,Q) and dD terms (B,nc,H,tiles);
        # bf16: in_c's hi + lo halves (B,nc,H,N,2P)
        G, t = plan.groups, -(-Q // SSD_TILE)
        ds = torch.empty((B, nc, H, N, P), dtype=f32, device=dev)
        dlast = torch.empty((B, nc, H, -(-N // _BWD_PASS_ROWS)), dtype=f32,
                            device=dev)
        dbc = torch.empty((2, G, B, S, N), dtype=f32, device=dev)
        dcb = torch.empty((G, B, nc, Q, Q), dtype=f32, device=dev)
        dcum = torch.empty((B, nc, H, t, Q), dtype=f32, device=dev)
        dd = torch.empty((B, nc, H, t), dtype=f32, device=dev)
        insb = (torch.empty((B, nc, H, N, 2 * P), dtype=x.dtype, device=dev)
                if x.dtype == torch.bfloat16 else None)
        lib = _native.library("ssd_bwd")
        fn = (lib.repro_ssd_scan_bwd_bf16 if x.dtype == torch.bfloat16
              else lib.repro_ssd_scan_bwd_f32)
        with _native.on_device(dev):
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), D.data_ptr(), cum.data_ptr(),
                    CB.data_ptr(), ins.data_ptr(), dy.data_ptr(),
                    None if dfinal is None else dfinal.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                    dBm.data_ptr(), dCm.data_ptr(), dD.data_ptr(),
                    dinit.data_ptr(), ds.data_ptr(), dlast.data_ptr(),
                    dbc.data_ptr(), dcb.data_ptr(), dcum.data_ptr(),
                    dd.data_ptr(), None if insb is None else insb.data_ptr(),
                    B, S, H, P, N, Q, plan.heads,
                    _native.current_stream(dev))
        _native.check(rc, "ssd_scan_bwd")
        with _lock:
            launches["ssd_scan_bwd"] += 1
    else:
        for t in (dx, dBm, dCm, ddt, dA, dD):
            t.zero_()
        if dfinal is None:
            dinit.zero_()
        else:
            dinit.copy_(dfinal)
    return dx, ddt, dA, dBm, dCm, dD, dinit
