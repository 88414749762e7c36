"""Attention kernels for Hopper — the port of ``repro/kernels/attention.py``:
prefill ``flash_attention`` (``_fa_kernel``) and ``decode_attention``
(``_dec_kernel``).

Prefill.

q (B, S, H, D) and k, v (B, S, KV, D), bf16 or f32; the output is in q's
dtype. Scale 1/sqrt(D); causal mask, sliding window (``cols > rows -
window``), tanh softcap and GQA (kv head ``h // (H/KV)``). Query and key
positions are 0..S-1, as in a prefill.

Kernel: ``csrc/flash_attention.cu``, any D up to 256, zero-padded to a
compiled width ``dp`` in shared memory only (output columns >= D are not
stored). A block walks the key tiles of its query tile in a loop with an
online softmax whose m, l and acc are f32 (the Pallas kernel carries them
in VMEM across a sequential grid axis, which Hopper's blocks do not have);
the ragged end of S is masked in the kernel instead of padded in device
memory, and key tiles that the causal and window masks cover fully are
skipped. bf16 runs on the tensor cores: each warp owns 16 query rows,
q·kᵀ and P·V are ``mma.sync`` m16n8k16 with f32 accumulators fed by
``ldmatrix`` from a ring of ``cp.async`` copies, and the score fragments
become P·V's operand in registers after p is rounded to bf16 (as the
Pallas kernel casts p to v's dtype; l sums the unrounded p). f32 stays on
the CUDA cores in IEEE f32 (no TF32). ``plan_flash`` picks the query rows
a block takes per head (64 or 128), the query heads of one kv head it
holds (they share each K/V tile), whether two warp groups split each key
stage (their (m, l, acc) merged in group order: no atomics), the key
tile and ``dp`` from the shapes and masks alone, so a prefill can be
captured in a CUDA graph.

Bound on an H100 SXM: the cold-LLM prefill (S = 64) is bound by launch
latency; granite-moe-3b-a800m's (1, 512, 24/8, 64) by its 4.19 MB of q,
k, v and o (1.25 µs); a long prefill (S = 2048, 15 heads, D = 64) by its
≈ 8 GFLOP of the causal half at the 989 TFLOP/s bf16 peak (8 µs).

``flash_attention_plain`` is the plain version (``flash_attention_ref``):
scores and softmax in f32 over the whole (S, S) matrix, cast to q's dtype
at the end.

Training. Under grad (grad mode on and q, k or v requiring grad)
``flash_attention`` runs as a ``torch.autograd.Function``: its forward asks
the kernel for each query row's log-sum-exp as well (``lse`` (B, H, S) f32,
m + log l of the scaled, softcapped scores; the inference path passes
null), and its backward is ``flash_attention_bwd`` (``csrc/
flash_attention_bwd.cu``, which replaces no Pallas kernel: the JAX package
differentiates its jnp attention). It recomputes P = exp(s - lse) tile
by tile in three launches (δ = rowsum(dO∘o); dK and dV a key tile of one
kv head, looping over its query heads, so the GQA sum needs no atomics; dQ
a query tile), counted as one, along ``plan_flash_bwd``'s route: in bf16
with D <= 128 every product on the tensor cores (``mma.sync`` m16n8k16
from ``ldmatrix`` fragments of bf16 tiles, P and dS rounded once to bf16
in registers as the A fragments of their products, as the forward rounds
p), in f32 (IEEE, no TF32) and for a wider bf16 head on the CUDA cores.
``flash_attention_bwd_plain`` spells out the same formulas over the whole
score matrix in f32. Bound on an H100 SXM at smollm-360m's training shape
(4, 512, 15/5, 64) in bf16: ~7.0 GFLOP of the causal products, 7 µs at the
tensor-core peak.

Decode. One new token per row, q (B, H, D), against a KV cache k, v
(B, W, KV, D) that is a ring buffer: slot w holds position
``pos - ((pos - w) mod W)``, visible when that is >= 0 and, with a
window, > ``pos - window`` (``layers.attn_decode_step``'s rule; with
``pos = length - 1`` and W = S it is the Pallas kernel's valid prefix).
The cache is in q's dtype, or int8 with per-entry scales (B, W, KV) f32,
dequantized as the reference rounds it: ``cache.to(q) * scale.to(q)``.
Softcap and GQA as in prefill; any head dim up to 256. Kernel:
``csrc/decode_attention.cu``, split over W (flash decoding): block (b, kv
head, group of up to 4 query heads, split) walks one chunk of the cache
with cp.async copies of the rows in their own dtype, a row's dot product
reduced over lanes by shuffles, and writes its chunk's (m, l, acc); a
second kernel merges the splits in split order (one launch counted).
``plan_decode`` picks the head groups, lanes a row and chunk from the
shapes alone, never from ``pos``, so a decode step can be captured in a
CUDA graph. Entries that the mask hides are not read. For bf16 q the
unnormalized p is rounded to bf16 before P·V, as in the Pallas kernel.
Bound on an H100 SXM: the cache bytes, 2·B·W·KV·D elements a step (6.26
µs at B 4, W 4096, KV 5, D 64 in bf16). ``decode_attention_plain`` is the
masked full softmax in f32.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _native
from repro_torch.kernels.matmul import SMS

NEG_INF = -2.0e38

launches = {"flash_attention": 0, "flash_attention_bwd": 0,
            "decode_attention": 0}
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


def _mask(S: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(S, S) bool: which keys (columns) each query row sees."""
    idx = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= idx[None, :] <= idx[:, None]
    if window is not None:
        mask &= idx[None, :] > idx[:, None] - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          return_lse: bool = False):
    """Masked softmax attention in f32 over the whole score matrix; with
    ``return_lse``, (out, the rows' log-sum-exp (B, H, S) f32)."""
    _check(q, k, v)
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~_mask(S, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


FLASH_MAX_D = 256
# the widths the kernels are compiled for (csrc/flash_attention.cu); D is
# zero-padded to the first that holds it
FLASH_DP = {torch.bfloat16: (32, 64, 80, 96, 112, 128, 192, 256),
            torch.float32: (32, 64, 96, 128, 192, 256)}
FLASH_MAX_WARPS = 8      # warps a bf16 block
_SM_SMEM = 233472        # shared memory an SM holds (228 KB), 1 KB a block
_SM_THREADS = 2048
_SM_REGS = 65536
_SM_WARPS_BUSY = 16      # warps that keep an SM's pipes busy (4 a quarter)
_F32_BQ, _F32_BK, _F32_THREADS = 64, 64, 256


class FlashPlan(NamedTuple):
    bq: int        # query rows a head in a block: 64 or 128 (bf16), 64 (f32)
    heads: int     # query heads of one kv head a block holds (share K/V)
    ksplit: int    # warp groups that split each key stage (bf16 1 or 2)
    bk: int        # keys a group takes per stage
    dp: int        # D padded in shared memory
    stages: int    # cp.async ring depth (bf16; f32 loads synchronously: 1)
    threads: int   # threads a block
    smem: int      # dynamic shared memory a block, bytes
    blocks: int    # blocks of the launch


def _bf16_cfg(dp: int) -> Tuple[int, int, int]:
    """(keys a group takes per stage, ring depth of an unsplit block,
    registers a thread) of the bf16 kernel at width ``dp``, as ``Bf16Cfg``
    in the kernel has them; the registers are what ``ptxas -v`` reported
    on an H100 build (at most 128 where the kernel asks for two blocks an
    SM)."""
    regs = {32: 122, 64: 128, 80: 126, 96: 128, 112: 203, 128: 215,
            192: 216, 256: 255}[dp]
    return (32, 2, regs) if dp > 128 else (64, 3, regs)


def _visible_tiles(S: int, q0: int, bq: int, keys: int, causal: bool,
                   window: Optional[int]) -> int:
    """Stages of ``keys`` keys that query tile q0 .. q0 + bq - 1 reads."""
    last = min(q0 + bq, S) - 1
    end = last + 1 if causal else S
    begin = max(0, q0 - window + 1) if window else 0
    return -(-end // keys) - begin // keys


def flash_plans(B: int, S: int, H: int, KV: int, D: int,
                dtype: torch.dtype) -> List[FlashPlan]:
    """Every cut of (B, S, H, KV, D) that the kernel of ``dtype`` takes."""
    if D > FLASH_MAX_D:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"up to {FLASH_MAX_D}, got {D}")
    if dtype not in FLASH_DP:
        raise TypeError(f"flash_attention: no CUDA kernel for {dtype}")
    dp = next(w for w in FLASH_DP[dtype] if w >= D)
    if dtype == torch.float32:
        smem = 4 * (dp * (_F32_BQ + 4) * 2 + _F32_BK * dp
                    + _F32_BK * (_F32_BQ + 4))
        return [FlashPlan(_F32_BQ, 1, 1, _F32_BK, dp, 1, _F32_THREADS, smem,
                          B * H * -(-S // _F32_BQ))]
    bk, nst, _ = _bf16_cfg(dp)
    rep = H // KV
    plans = []
    for bq in (128, 64):
        for heads in range(rep, 0, -1):
            for ks in (1, 2):
                warps = heads * bq // 16 * ks
                if rep % heads or warps > FLASH_MAX_WARPS:
                    continue
                stages = 2 if ks > 1 else nst
                ring = 2 * (dp + 8) * stages * 2 * ks * bk
                merge = (ks - 1) * warps // ks * 32 * (dp // 2 + 4) * 4
                smem = 2 * (dp + 8) * heads * bq + max(ring, merge)
                plans.append(FlashPlan(bq, heads, ks, bk, dp, stages,
                                       warps * 32, smem,
                                       B * (H // heads) * -(-S // bq)))
    return plans


def _resident(plan: FlashPlan) -> int:
    """Blocks of ``plan`` an SM holds at once: shared memory, threads and
    registers (``_bf16_cfg``'s count)."""
    regs = _bf16_cfg(plan.dp)[2]
    return max(1, min(_SM_SMEM // (plan.smem + 1024),
                      _SM_THREADS // plan.threads,
                      _SM_REGS // (plan.threads * regs)))


@functools.lru_cache(maxsize=1024)
def plan_flash(B: int, S: int, H: int, KV: int, D: int,
               dtype: torch.dtype, causal: bool = True,
               window: Optional[int] = None) -> FlashPlan:
    """How ``flash_attention``'s kernel cuts (B, S, H, KV, D), from the
    shapes and masks alone, so a prefill can be captured in a CUDA graph.
    f32 has one cut (64 query rows of one head). A bf16 block runs its key
    stages one after another, each a chain of dependent products and
    softmax steps that a few warps cannot hide, so the time of a cut is
    taken as the larger of its longest block (stages, each split across
    ``ksplit`` warp groups) and its work spread over the card (warp-stages
    over ``SMS`` x ``_SM_WARPS_BUSY`` resident warps). Of the cuts that fit
    ``FLASH_MAX_WARPS``, the least such time, then the fewest threads, then
    more heads a block (each K/V tile read once for them), then the taller
    tile. So granite-moe-3b-a800m's (1, 512, 24/8) and a long prefill (1,
    2048, 15/5) take 64-row tiles with each key stage split over two warp
    groups, and smollm-360m's cold 64-token prefill one 4-warp block a
    head. Raises ``ValueError`` for D > ``FLASH_MAX_D``."""
    plans = flash_plans(B, S, H, KV, D, dtype)
    if len(plans) == 1:
        return plans[0]

    def key(p: FlashPlan):
        warps = p.threads // 32
        stages = [_visible_tiles(S, q0, p.bq, p.ksplit * p.bk, causal,
                                 window) for q0 in range(0, S, p.bq)]
        longest = max(stages, default=0)
        work = B * (H // p.heads) * sum(stages) * warps
        busy = min(_SM_WARPS_BUSY, _resident(p) * warps)
        return (max(longest, work / (SMS * busy)), p.threads, -p.heads,
                -p.bq)

    return min(plans, key=key)


def visible_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs one head's prefill attends: the causal triangle
    (query r sees keys 0..r), cut by a window to the last ``window`` keys
    up to r; without the causal mask, keys after r too. The cost
    functions count FLOPs over these pairs only."""
    w = S if window is None else min(int(window), S)
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return S * S - (S - w) * (S - w + 1) // 2


def flash_cost(out, q, k, v, causal, window, softcap,
               want_lse) -> Tuple[float, float]:
    """4·D FLOPs a visible pair a head (q·kᵀ and p·v); q, k, v read once,
    o (and the rows' lse) written once."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    return (4 * B * H * D * visible_pairs(S, causal, window),
            q.element_size() * 2 * B * S * (H + KV) * D
            + (4 * B * H * S if want_lse else 0))


def flash_bwd_cost(out, q, k, v, o, lse, do, *, causal=True, window=None,
                   softcap=None) -> Tuple[float, float]:
    """10·D FLOPs a visible pair a head (the scores recomputed, dP, dV, dQ,
    dK); q, k, v, o, do and lse read once, dq, dk, dv written once."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    return (10 * B * H * D * visible_pairs(S, causal, window),
            q.element_size() * 4 * B * S * (H + KV) * D + 4 * B * H * S)


def decode_cost(out, q, k, v, pos, *, window=None, softcap=None,
                k_scale=None, v_scale=None) -> Tuple[float, float]:
    """4·H·D FLOPs a cache entry; every entry of the cache read once (the
    visible ones depend on ``pos``, which lies on the device: an upper
    bound until the cache is full), q and pos read, the output written."""
    B, H, D = q.shape
    W, KV = k.shape[1], k.shape[2]
    entry = 2 * KV * D * k.element_size() + (
        2 * KV * 4 if k_scale is not None else 0)
    return (4 * H * D * B * W,
            B * W * entry + 2 * B * H * D * q.element_size() + 4 * B)


@_native.costed("flash_attention", flash_cost)
def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: Optional[int],
                   softcap: Optional[float], want_lse: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse or None): the kernel (or, on the CPU, the plain version),
    writing the rows' log-sum-exp too where ``want_lse``."""
    _check(q, k, v)
    if _native.on_cpu("flash_attention", q, k, v,
                      dtypes=(torch.float32, torch.bfloat16), meta=True):
        if want_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap), None
    B, S, H, D = q.shape
    plan = plan_flash(B, S, H, k.shape[2], D, q.dtype, causal, window)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, "
                         f"got {window}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B and S and H and D and not q.is_meta:
        lib = _native.library("flash_attention")
        fn = (lib.repro_flash_attention_bf16 if q.dtype == torch.bfloat16
              else lib.repro_flash_attention_f32)
        with _native.on_device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    B, S, H, k.shape[2], D, int(causal),
                    int(window) if window is not None else 0,
                    float(softcap) if softcap else 0.0,
                    plan.bq, plan.heads, plan.ksplit, plan.dp,
                    _native.current_stream(q.device))
        _native.check(rc, "flash_attention")
        with _lock:
            launches["flash_attention"] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention over a prefill; under grad (grad mode on and an input
    requiring grad) the autograd Function whose backward is
    ``flash_attention_bwd``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _flash_forward(q, k, v, causal, window, softcap, False)[0]


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward keeps o and the
    rows' lse, the backward is the ``flash_attention_bwd`` kernel (its
    plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _flash_forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# the backward of prefill attention
# ---------------------------------------------------------------------------
def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` by the explicit formulas, in f32
    over the whole score matrix: P = exp(s - lse) (masked entries 0), dP =
    dO·Vᵀ, δ = rowsum(dO∘o), dS = P∘(dP - δ), times 1 - tanh² of the
    softcap's argument; dQ = dS·K/√D, dK = dSᵀ·Q/√D and dV = Pᵀ·dO summed
    over each kv head's query heads; each in its input's dtype."""
    _check(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    f = torch.float32
    qf, dof = q.to(f), do.to(f)
    kf = k.to(f).repeat_interleave(rep, dim=2)
    vf = v.to(f).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(D)
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    mask = _mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(f)[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.to(f)).sum(-1).permute(0, 2, 1)      # (B, H, S)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) / math.sqrt(D)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, rep, D).sum(3)
    dv = dv.reshape(B, S, KV, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


FLASH_BWD_MMA_MAX_D = 128   # the tensor-core route's widest head
_BWD_MMA_ROWS = 64          # rows (keys or queries) a tensor-core block
_BWD_MMA_THREADS = 128      # a warp group: four warps of 16 rows


class FlashBwdPlan(NamedTuple):
    route: str     # "mma" (bf16 on the tensor cores) or "simt" (CUDA cores)
    rows: int      # keys a dK/dV block, query rows a dQ block; as many
                   # of the other side a tile of its ring
    dp: int        # D padded in shared memory
    split: int     # warp groups that split a dK/dV block's query items
    threads: int   # threads a dQ block (a dK/dV block: split times that)
    smem: int      # dynamic shared memory a dQ block, bytes
    smem_dkdv: int     # dynamic shared memory a dK/dV block, bytes
    blocks_dkdv: int   # blocks of the dK/dV launch
    blocks_dq: int     # blocks of the dQ launch


def _bwd_items(S: int, rows: int, causal: bool,
               window: Optional[int]) -> List[int]:
    """Query tiles that each key tile of a dK/dV block visits."""
    out = []
    for k0 in range(0, S, rows):
        qt0 = k0 // rows if causal else 0
        q_end = min(S, k0 + rows - 1 + window) if window else S
        out.append(-(-q_end // rows) - qt0)
    return out


@functools.lru_cache(maxsize=1024)
def plan_flash_bwd(B: int, S: int, H: int, KV: int, D: int,
                   dtype: torch.dtype, causal: bool = True,
                   window: Optional[int] = None) -> FlashBwdPlan:
    """How ``flash_attention_bwd``'s kernels cut (B, S, H, KV, D), from the
    shapes and masks alone, so a training step can be captured in a CUDA
    graph. bf16 with D <= ``FLASH_BWD_MMA_MAX_D``: the tensor-core route,
    D padded to a multiple of 16, 64-row blocks of four 16-row warps
    against 64-row tiles of the other side (a 2-deep ring); a dK/dV
    block's query items split over two warp groups (their sums added in
    group order) where the grid leaves the card under 1.5 blocks an SM, so
    its heaviest block sets the time: smollm-360m's causal (4, 512, 15/5)
    microbatch, 160 blocks, the first key tile's holding 24 items (0.0970
    ms of device time split, 0.1082 not, on an H100 SXM), but not its
    batch of 8 (320 blocks: 0.1486 ms unsplit, 0.1556 split).
    f32 (IEEE, no TF32) and bf16 with a wider head: the CUDA-core route at
    the forward's widths for the dtype, 64-row tiles (32 above 128) of 256
    threads. Raises ``ValueError`` for D > ``FLASH_MAX_D``."""
    if D > FLASH_MAX_D:
        raise ValueError(f"flash_attention_bwd: the CUDA kernel takes "
                         f"head_dim up to {FLASH_MAX_D}, got {D}")
    if dtype not in FLASH_DP:
        raise TypeError(f"flash_attention_bwd: no CUDA kernel for {dtype}")
    if dtype == torch.bfloat16 and D <= FLASH_BWD_MMA_MAX_D:
        dp, rows = -(-D // 16) * 16, _BWD_MMA_ROWS
        tile = rows * (dp + 8) * 2
        blocks = B * KV * -(-S // rows)
        # a dK/dV block's items (query head, query tile) run one after
        # another in its warp group: split them over two groups where the
        # grid leaves the card under 1.5 blocks an SM, so the heaviest
        # blocks (the first key tiles under a causal mask) set the time
        most = (H // KV) * max(_bwd_items(S, rows, causal, window))
        split = 2 if 2 * blocks < 3 * SMS and most > 1 else 1
        smem_kv = 2 * tile + 4 * split * tile + 4 * split * rows * 4
        return FlashBwdPlan("mma", rows, dp, split, _BWD_MMA_THREADS,
                            2 * tile + 4 * tile + 4 * rows * 4, smem_kv,
                            blocks, B * H * -(-S // rows))
    dp = next(w for w in FLASH_DP[dtype] if w >= D)
    rows = 32 if dp > 128 else 64
    ld, lp = dp + 1, rows + 1
    smem = 4 * (4 * rows * ld + 2 * rows * lp + 2 * rows)
    return FlashBwdPlan("simt", rows, dp, 1, 256, smem, smem,
                        B * KV * -(-S // rows), B * H * -(-S // rows))


@_native.costed("flash_attention_bwd", flash_bwd_cost)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` given its output ``o``,
    the rows' ``lse`` (B, H, S) f32 and the output's gradient ``do``: the
    kernels on CUDA tensors along ``plan_flash_bwd``'s route (three
    launches counted as one), the plain version on CPU tensors."""
    _check(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (B, H, S):
        raise ValueError(f"flash_attention_bwd: o, do must be "
                         f"{tuple(q.shape)} and lse {(B, H, S)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}")
    dt = (torch.float32, torch.bfloat16)
    if _native.on_cpu("flash_attention_bwd", q, k, v, o, lse, do,
                      each=(dt, (q.dtype,), (q.dtype,), (q.dtype,),
                            (torch.float32,), (q.dtype,)), meta=True):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, "
                         f"got {window}")
    plan = plan_flash_bwd(B, S, H, KV, D, q.dtype, causal, window)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if B and S and H and D and not q.is_meta:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        lib = _native.library("flash_attention_bwd")
        fn = (lib.repro_flash_attention_bwd_bf16
              if q.dtype == torch.bfloat16
              else lib.repro_flash_attention_bwd_f32)
        route = ((int(plan.route == "mma"), plan.split)
                 if q.dtype == torch.bfloat16 else ())
        with _native.on_device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    B, S, H, KV, D, int(causal),
                    int(window) if window is not None else 0,
                    float(softcap) if softcap else 0.0, plan.dp, *route,
                    _native.current_stream(q.device))
        _native.check(rc, "flash_attention_bwd")
        with _lock:
            launches["flash_attention_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# decode: one token against a ring-buffer cache
# ---------------------------------------------------------------------------
def _check_decode(q, k, v, pos, k_scale, v_scale) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B,H,D) and k, v "
                         f"(B,W,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if (k.shape[0], k.shape[3]) != (B, D) or k.shape[1] == 0 \
            or k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"decode_attention: k, v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: pos must be ({B},), got "
                         f"{tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both k_scale and v_scale "
                         "or neither")
    if k_scale is not None and (tuple(k_scale.shape) != tuple(k.shape[:3])
                                or k_scale.shape != v_scale.shape):
        raise ValueError(f"decode_attention: scales must be "
                         f"{tuple(k.shape[:3])}, got {tuple(k_scale.shape)},"
                         f" {tuple(v_scale.shape)}")


DECODE_MAX_D = 256       # 32 lanes x 8 elements
_DECODE_WARPS = 4        # warps a block
_DECODE_RPS = 4          # rows a lane group takes per stage
_DECODE_HG = 4           # most query heads a block
_DECODE_CHUNK = 256      # most cache entries a split, where SMS are filled


class DecodePlan(NamedTuple):
    hg: int        # query heads a block, 1 to 4 (a smaller last group masks)
    hgroups: int   # head groups a kv head
    lpr: int       # lanes that hold one cache row (8 elements each)
    tile: int      # cache entries a block takes per stage
    chunk: int     # cache entries a split: a multiple of tile
    split: int     # splits of W (1: no merge kernel)
    tiles: int     # ceil(W / tile)
    blocks: int    # blocks of the main launch


@functools.lru_cache(maxsize=1024)
def plan_decode(B: int, W: int, H: int, KV: int, D: int) -> DecodePlan:
    """How ``decode_attention``'s kernel cuts (B, W, H, KV, D): from the
    shapes alone (never ``pos``), so that a decode step can be captured in
    a CUDA graph. The query heads of a kv head go to ceil(g/4) groups; D to
    the fewest lanes (4, 8, 16, 32) that hold it at 8 elements a lane; W to
    ``split`` chunks of whole tiles, as many as it takes for B·KV·groups·
    split blocks to reach ``SMS`` where W has the tiles (else one tile a
    split), and chunks of at most ``_DECODE_CHUNK`` entries, so that more
    blocks hide each other's latency."""
    if D > DECODE_MAX_D:
        raise ValueError(f"decode_attention: the CUDA kernel takes head_dim "
                         f"up to {DECODE_MAX_D}, got {D}")
    g = H // KV
    hgroups = -(-g // _DECODE_HG)
    per = -(-g // hgroups)          # heads a block
    lpr = next(n for n in (4, 8, 16, 32) if 8 * n >= D)
    tile = _DECODE_WARPS * (32 // lpr) * _DECODE_RPS
    tiles = -(-W // tile)
    base = B * KV * hgroups
    per_split = max(1, min(tiles // -(-SMS // base), _DECODE_CHUNK // tile))
    split = -(-tiles // per_split)
    return DecodePlan(per, hgroups, lpr, tile, per_split * tile, split,
                      tiles, base * split)


def visible(pos: torch.Tensor, W: int,
            window: Optional[int] = None) -> torch.Tensor:
    """(B, W) bool: which ring slots the token at ``pos`` (B,) sees."""
    p = pos.to(torch.int64)[:, None]
    slots = torch.arange(W, device=pos.device)[None, :]
    entry = p - torch.remainder(p - slots, W)
    ok = entry >= 0
    if window is not None:
        ok &= entry > p - window
    return ok


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Masked softmax over the whole cache in f32, cast to q's dtype."""
    _check_decode(q, k, v, pos, k_scale, v_scale)
    B, H, D = q.shape
    W, KV = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale[..., None].to(q.dtype)
        v = v.to(q.dtype) * v_scale[..., None].to(q.dtype)
    kf = k.to(torch.float32).repeat_interleave(H // KV, dim=2)
    vf = v.to(torch.float32).repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bhd,bwhd->bhw", q.to(torch.float32), kf) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~visible(pos, W, window)[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhw,bwhd->bhd", p, vf).to(q.dtype)


@_native.costed("decode_attention", decode_cost)
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_decode(q, k, v, pos, k_scale, v_scale)
    quant = k_scale is not None
    cache = (torch.int8,) if quant else (q.dtype,)
    ts = [q, k, v, pos]
    each = [(torch.float32, torch.bfloat16), cache, cache, (torch.int32,)]
    if quant:
        ts += [k_scale, v_scale]
        each += [(torch.float32,)] * 2
    if _native.on_cpu("decode_attention", *ts, each=each, meta=True):
        return decode_attention_plain(q, k, v, pos, window=window,
                                      softcap=softcap, k_scale=k_scale,
                                      v_scale=v_scale)
    B, H, D = q.shape
    W, KV = k.shape[1], k.shape[2]
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, "
                         f"got {window}")
    plan = plan_decode(B, W, H, KV, D)
    out = torch.empty_like(q)
    if B and H and not q.is_meta:
        # the splits' (acc, m, l) in f32, merged by the second kernel
        scratch = (torch.empty(plan.split * B * H * (D + 2),
                               dtype=torch.float32, device=q.device)
                   if plan.split > 1 else None)
        lib = _native.library("decode_attention")
        fn = (lib.repro_decode_attention_bf16 if q.dtype == torch.bfloat16
              else lib.repro_decode_attention_f32)
        with _native.on_device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    k_scale.data_ptr() if quant else None,
                    v_scale.data_ptr() if quant else None,
                    pos.data_ptr(), out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    B, W, H, KV, D,
                    int(window) if window is not None else 0,
                    float(softcap) if softcap else 0.0,
                    plan.hg, plan.hgroups, plan.lpr, plan.chunk, plan.split,
                    _native.current_stream(q.device))
        _native.check(rc, "decode_attention")
        with _lock:
            launches["decode_attention"] += 1
    return out
