"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It

  1. prints the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, the TF32 flags (asserted off) and whether the machine
     has ``ml_dtypes`` (the port does not use it);
  2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel) and prints the build time;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes resnet50@224 and the smollm-360m prefill and decode give it
     (max|d|/max|plain| <= 2e-5 in f32, <= 2e-2 in bf16; the dequant
     kernels bitwise, max|d| = 0), and times the kernel, the plain version
     and one library call with CUDA events; ``decode_attention``
     also over the Pallas sweep in its prefix form, a wrapped ring with a
     window, the int8 cache, a softcap, granite-moe-3b-a800m's heads,
     zamba2-2.7b's head dim 80 and head dims 100, 67 and 256, each row
     printing its
     split plan; ``flash_attention`` at smollm-360m's 64- and 2048-token
     prefills, granite-moe-3b-a800m's 512-token prefill (24/8 heads),
     zamba2-2.7b's head dim 80 in bf16 and f32, ragged S, head dims 32,
     67, 100, 128 and 256 with windows and softcaps, and a batch whose
     plan puts two query heads in a block, each row printing its
     ``plan_flash`` cut; ``winograd_tile_matmul`` at resnet50's four
     stages and two ragged shapes, each row printing its path, tile and
     blocks; the f32 ``matmul`` also at granite-moe-3b-a800m's router
     (decode at 1 and 4 tokens, a 512-token prefill), mamba2-2.7b's f32
     decode projections and its tied head reading ``embed`` K-major in
     place (decode and a 1024-token prefill), ragged and unaligned edges,
     each row printing its path, tile and split; the bf16 ``matmul`` also
     at the decode projections (M 1 and 4) of smollm-360m,
     granite-moe-3b-a800m and mamba2-2.7b, the prefill projections of
     granite (512 tokens) and mamba2 (1024), the tied heads at decode and
     prefill reading
     ``embed`` K-major in place, and ragged, unaligned edges;
     ``gmm_blocks`` at granite-moe-3b-a800m's expert GEMMs (C 8 at decode,
     208 at a 512-token prefill) in bf16 and in f32 (each f32 row printing
     its ``plan_f32_gemm`` plan, each launch's output first handed a
     NaN-filled block), with ``group_sizes`` from a top-8-of-40
     routing of 1 and of 4 tokens and a clipped prefill, and over the
     Pallas sweep; for the bf16 ``matmul``, ``gmm_blocks``,
     ``decode_attention``, the f32 ``matmul``, ``flash_attention`` and
     ``winograd_tile_matmul`` two launches on the same
     inputs must give the same bits, and their device time (the calls
     replayed from a CUDA graph) is printed beside the host-timed one
     (``ssd_scan`` too, below);
     ``ssd_scan`` at mamba2-2.7b's S 1024 in bf16 from a zero and a
     random state, in f32, at B 4 and at S 512,
     zamba2-2.7b's N 64, a ragged shape in f32 and bf16 and the Pallas
     sweep (y and the final state, each row printing the blocks of its
     four phases, two launches bitwise equal, a device time);
     ``matmul_packed`` at resnet50's packed head, a tblock up projection
     (64,960)x(960,2560) in f32 and bf16 x (beside the f32 ``matmul``'s
     row of that shape) and ragged panels, and ``matmul_dequant_int8`` and
     ``matmul_dequant_int4`` at the resnet50 head, that projection, decode
     at M 1 and 8 and ragged tiles with an odd K, each row printing its
     ``plan_f32_gemm`` plan (and byte loader), two launches bitwise equal,
     a device time, each launch's output first handed a NaN-filled block
     (int8 beside ``torch._weight_int8pack_mm``); with
     ``--kernels-only`` the script stops here (a first check of a new
     kernel, without the paths or a result line);
  4. drives the CNN path: resnet50 at image 224, width 1.0, from
     ``build_cnn`` through ``ColdEngine(store_fmt="super")``, ``decide`` with
     the real profiler, then ``run_cold``, and two more ``run_cold``s under
     pinned plans (Winograd for every 3x3/s1 conv with the packed head;
     im2col for every conv with the direct head), each output held to an
     all-plain forward on the card (max|d|/max|ref| <= 1e-4); then the
     lossy CNN path: a second engine with ``allow_lossy=True``, ``decide``
     with ``SyntheticProfiler``, and ``run_cold`` with the head on the
     ``int8``, ``int4`` and ``bf16`` caches (im2col convs), each held to an
     all-plain forward whose head uses the same (dequantized) weights;
     then continuous mode (paper §3.5): a ``ContinuousSession`` on the
     same engine, K_cold the decided plan (or the pinned im2col plan where
     the decided plan already is K_warm on every weighted layer),
     ``cold_infer`` from a first read and ``warm_infer(wait=True)`` twice,
     each output held to the all-plain forward, the times beside
     ``run_warm``; it fails unless the layers whose K_warm differs all
     switched (at least one); then the fleet: ``FrontDoor(n_workers=2,
     device="cuda")`` serving resnet50@224 from two worker processes, an
     SD-card-class edge disk emulated under their local reads, on one
     plan decided with measured profiles under that disk and written into
     both workers' stores (so both and every restart hold it): a SIGKILL
     of the first worker right after a request is dispatched to it, the
     failover served from disk by the second (held to the all-plain
     forward), the restart, a cold start on the restarted worker raced
     against the second's RAM (peer layers must be fetched), and a warm
     run on each; every output bitwise equal to the failover's, and no
     request left in flight or queued. Each result carries its own
     request's kernel launches, which must add up to the plan's launches
     per forward times the forwards served;
  5. drives the cold-LLM path: smollm-360m at its full published width
     (d_model 960, 15/5 heads, d_ff 2560, vocab 49152) and ``LLM_DEPTH``
     blocks, random weights from seed 0, a 64-token prompt, from
     ``build_llm_graph`` through ``ColdEngine(store_fmt="super")``,
     ``decide`` with the real profiler, ``run_cold`` in nnv12 and
     sequential mode, ``run_cold`` under two pinned plans (``f32_direct``
     everywhere; ``bf16_cast`` from the bf16 cache everywhere), and
     ``run_warm``; each logits tensor is held to an all-plain forward on the
     card (atol 0.1, rtol 0.05: the reference's own gate for this graph),
     and the two pinned plans must give bitwise-equal logits; then the
     lossy LLM path at ``LOSSY_DEPTH`` blocks: ``allow_lossy=True``,
     ``decide`` with ``SyntheticProfiler``, the ``int8``, ``int4`` and
     ``bf16_cast`` caches, and ``run_cold`` under the decided plan and with
     every tblock and the head pinned to each cache, each held to an
     all-plain forward on the same dequantized weights (same gate); the
     cache bytes of the matmul layers must be >= 1.8x (int8) and >= 3x
     (int4) below ``bf16_cast``;
  6. drives the serving path: smollm-360m at full width and ``SERVE_DEPTH``
     blocks through ``ColdServer(device="cuda")`` -> ``add_model`` ->
     ``decide`` -> ``cold_start_llm(max_new_tokens=16)``: the first token
     must precede the last decode prep, at least one weight prep must
     overlap the exec chain, 16 tokens must come back, ``decode_attention``
     must launch once a block for every ``decode_step``, the prefill
     logits must pass the LLM gate and the KV reservation must leave the
     ``MemoryBudget``; then teacher-forced ``decode_step`` over 48 tokens
     with the kernels against the plain versions (bf16 cache, int8 cache,
     a 32-entry window ring; LLM gate) and a ``BatchedServer(max_batch=4,
     max_len=512)`` run of 6 greedy requests, each of which must finish
     with its token count (agreement with the plain run is reported,
     and for each request that leaves it, its first flip);
  7. drives the moe family: granite-moe-3b-a800m at full width, all 32
     layers (``MOE_DEPTH``), bf16, weights drawn on the card: ``forward``
     on a 512-token prompt against the all-plain forward, one MoE layer on
     identical inputs, decode by steps against ``forward`` on 32 tokens and
     the ``BatchedServer`` run of the serving phase; a bf16 rounding
     upstream of the f32 router can flip a near-tie between experts, so
     the logits gates compare runs under the same routing (one replays the
     other's experts) and the free-running kernel and plain forwards must
     share 90 % of their (token, expert) assignments; the kernels'
     batched run is repeated replaying the plain run's routing
     (reported); then the model in f32 at ``MOE_F32_DEPTH`` layers (a
     cut): ``forward`` on the 512-token prompt against the all-plain f32
     forward under the same routing (``PATH_TOL`` relative to max|ref|);
     then
     the ssm family: mamba2-2.7b at full width, all 64 layers
     (``SSM_DEPTH``): in bf16 ``forward`` on 1024 tokens, each layer held
     to its plain version on the same input and the whole model's
     difference from the all-plain forward reported, and the same
     ``BatchedServer`` run; in f32
     ``forward`` against the all-plain forward and decode by steps against
     ``forward`` over two 256-token chunks (LLM gate);
  8. fails unless every kernel of a path launched during that path's runs
     (each path's launch counts are zeroed just before its runs and read
     just after; the fleet's are its served requests' own;
     ``gmm_blocks`` 3 times a layer per ``forward`` or
     ``decode_step``, ``ssd_scan`` once a layer per ``forward``) and no
     kernel was demoted by the fault ladder.

Every run of a decided plan in the CNN and LLM phases (nnv12,
sequential, nnv12_nosteal) starts from the first arm's state: the store
reopened with its lazy CRC-32C audit pending and its files fsynced and
evicted from the page cache (``posix_fadvise(DONTNEED)``); each
``run_cold`` line prints its starting state. The sequential arm's run
lands the audit of the raw entries it reads before its timer starts, so
its line prints the audit's own seconds ("audit s"). One more nnv12 arm
follows it with that audit still landed (the store not reopened) and the
audit of the cache entries the decided plan reads landed (and timed)
first, its files evicted again: it pays no audit.

``LLM_DEPTH``, ``LOSSY_DEPTH`` and ``SERVE_DEPTH`` (16 of smollm-360m's
32 blocks, a cut for the run's time limit: the smollm-360m phases are host
work, ``decide()``'s profiling, cache writes and the software CRC-32C,
and grow with depth) are the first to cut should the run near its limit
again; the kernels run at full width either way.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. With no CUDA device, or without the repository's sources beside
it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
import importlib.metadata
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# peak rates by card (NVIDIA data sheets, dense): f32 without tensor
# cores, bf16 on the tensor cores, memory
PEAKS = {"sxm": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
         "pcie": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12}}

KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PATH_TOL = 1e-4
LLM_ATOL, LLM_RTOL = 0.1, 0.05
# the smollm-360m phases at 16 of its 32 blocks (a cut: at 32 blocks one
# H100 machine, whose host ran these host-bound phases 1.4-1.5x slower
# than others, took 1352.5 s, past the script's 1200 s budget)
LLM_DEPTH = 16
LOSSY_DEPTH = 16
SERVE_DEPTH = 16
MOE_DEPTH = 32
MOE_F32_DEPTH = 4   # the f32 granite forward: a cut of its 32 layers
SSM_DEPTH = 64
# whole-model MoE runs, kernels against plain: the share of (token, expert)
# assignments that must agree (a wrong hidden state routes near k/E = 0.2)
ROUTE_AGREE = 0.9
# cache bytes of the matmul layers (tblocks + LM head) below bf16_cast
LOSSY_BYTE_FLOORS = {"int8": 1.8, "int4": 3.0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of ``ops`` swapped for its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.attention import (decode_attention_plain,
                                               flash_attention_plain,
                                               plan_decode)
    from repro_torch.kernels.gmm import gmm_blocks_plain
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.kernels.ssd import ssd_scan_plain

    plain = {"matmul": matmul_plain, "flash_attention": flash_attention_plain,
             "decode_attention": decode_attention_plain,
             "dequant_int8": Q.dequant_int8_plain,
             "dequant_int4": Q.dequant_int4_plain,
             "matmul_dequant_int8": Q.matmul_dequant_int8_plain,
             "matmul_dequant_int4": Q.matmul_dequant_int4_plain,
             "gmm_blocks": gmm_blocks_plain, "ssd_scan": ssd_scan_plain}
    saved = {k: getattr(ops, k) for k in plain}
    for k, fn in plain.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


# the batched-serving request mix of every LLM path: (prompt length, new
# tokens), prompts drawn from numpy seed 2
BATCH_SHAPES = [(8, 8), (64, 32), (23, 16), (40, 24), (12, 12), (57, 20)]


def batched_run(params, cfg, dev, plain: bool):
    """The ``BATCH_SHAPES`` requests, greedy, through a
    ``BatchedServer(max_batch=4, max_len=512)`` (slots recycled). Returns
    ({rid: tokens}, decode steps, seconds, the launch counts of the run,
    zeroed just before it, {rid: [(slot, f32 logits row)]} of every pick)."""
    import numpy as np

    from repro_torch.device import on_stream
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchedServer, Request

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n, _ in BATCH_SHAPES]
    srv = BatchedServer(params, cfg, max_batch=4, max_len=512, device=dev)
    for i, (p, (_, m)) in enumerate(zip(prompts, BATCH_SHAPES)):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    picks, pick = {}, srv._pick

    def recording(req, row):
        tok = pick(req, row)
        # copied on the server's stream: the row's memory goes back to
        # that stream's pool when the step's logits are freed
        with on_stream(srv.stream):
            picks.setdefault(req.rid, []).append(
                (next(s for s, r in enumerate(srv.slot_req) if r is req),
                 row.float().clone()))
        return tok

    srv._pick = recording
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    srv.close()
    return ({r.rid: r.out_tokens for r in done}, srv.decode_steps, dt,
            counts, picks)


def report_batched(got, want, steps, dt, dt_p, picks, picks_p) -> bool:
    """Print a batched run against the plain kernels' run; True when every
    request finished with its token count. Greedy decoding diverges for
    good at the first flipped argmax, so for each request it also prints
    its slot, its logits rows up to its first flip against the LLM gate,
    and at the flip: max|d| of the two rows and how far the plain run
    preferred its token over the kernels' one (the plain margin). A
    recycled slot keeps its earlier requests' cache or state, so a
    request's history is the same in both runs only while the earlier
    requests of its slot gave the same tokens: the line says where not."""
    import torch

    agree = sum(a == b for i in got for a, b in zip(got[i], want.get(i, [])))
    total = sum(m for _, m in BATCH_SHAPES)
    finished = all(len(got.get(i, [])) == m
                   for i, (_, m) in enumerate(BATCH_SHAPES))
    print(f"  BatchedServer(max_batch=4, max_len=512): 6 requests, prompts "
          f"{[n for n, _ in BATCH_SHAPES]}, max_new_tokens "
          f"{[m for _, m in BATCH_SHAPES]}; all finished with their counts: "
          f"{finished}; {steps} decode_steps in {dt:.3f} s "
          f"({dt * 1e3 / steps:.3f} ms per step; plain "
          f"{dt_p * 1e3 / steps:.3f}); tokens agreeing with the plain "
          f"kernels' run: {agree}/{total}")
    margins = [float(torch.topk(r, 2).values.diff().abs()) for rs in
               picks_p.values() for _, r in rs]
    slot = {i: rs[0][0] for i, rs in picks.items() if rs}
    lines = []
    for i in sorted(got):
        a, b = got[i], want.get(i, [])
        n = min(len(a), len(b), len(picks.get(i, [])), len(picks_p.get(i, [])))
        j = next((k for k in range(n) if a[k] != b[k]), None)
        end = n if j is None else j + 1
        if end == 0:
            continue
        rows = torch.stack([r for _, r in picks[i][:end]])
        rows_p = torch.stack([r for _, r in picks_p[i][:end]])
        ok, _, _ = logits_gate(rows, rows_p)
        text = (f"req {i} slot {slot[i]}: rows in the gate "
                f"{int(ok.sum())}/{end}")
        if j is not None:
            at, at_p = rows[j], rows_p[j]
            text += (f", first flip at step {j}/{len(a)} (max|d| "
                     f"{float((at - at_p).abs().max()):.4f}, plain margin "
                     f"{float(at_p[b[j]] - at_p[a[j]]):.4f})")
        after = [r for r in sorted(got) if r < i and slot.get(r) == slot[i]
                 and got[r] != want.get(r)]
        if after:
            text += f", history differs (its slot served diverged {after})"
        lines.append(text)
    print(f"  per request, up to its first flip (the plain run's median "
          f"top-2 margin {float(torch.tensor(margins).median()):.4f}): "
          + "; ".join(lines))
    return finished


def profile_steps(label, step, n, extra=()) -> None:
    """Device busy time of ``step(0) .. step(n-1)`` under the profiler,
    kernels only (an aten op's device time is its kernels' again), and the
    five kernels with the most device time plus any whose name holds one of
    ``extra``. A breakdown only: reported, never gated."""
    import torch

    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kern) / 1e3  # ms
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        named = [e for e in kern if any(x in e.key for x in extra)]
        top += [e for e in named if e not in top]
        # the summed device time of the kernels ``extra`` names (a kernel
        # of several phases, each a kernel of its own)
        sums = "".join(
            f"; '{x}' kernels together "
            f"{sum(e.self_device_time_total for e in named if x in e.key) / 1e3 / n:.4f}"
            f" ms/step in {sum(e.count for e in named if x in e.key) / n:g}"
            f" launches" for x in extra)
        print(f"  profiler, {label}: wall {wall * 1e3 / n:.3f} ms/step, "
              f"device busy {busy / n:.3f} ms/step (idle share "
              f"{1 - busy / (wall * 1e3):.3f}); kernels by device time: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.4f}"
                          f" ms/step in {e.count / n:g} launches"
                          for e in top) + sums)
    except Exception as e:  # a breakdown only: report it, never fail on it
        print(f"  profiler: unavailable ({type(e).__name__}: {e})")


def evict(store) -> tuple:
    """Flush (fsync) every file of ``store`` and drop it from the page
    cache (``posix_fadvise(DONTNEED)``), after unmapping the pages an open
    reader's mmap holds (mapped pages are not dropped). Returns (files,
    bytes)."""
    import mmap

    mm = getattr(getattr(store, "_reader", None), "_mm", None)
    if mm is not None and not mm.closed:
        mm.madvise(mmap.MADV_DONTNEED)
    files = nbytes = 0
    for p in sorted(store.root.rglob("*")):
        if not p.is_file():
            continue
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        files, nbytes = files + 1, nbytes + p.stat().st_size
    return files, nbytes


def first_read_state(store) -> str:
    """Put ``store`` back where the first decided-plan arm found it: the
    reader closed, so the next read reopens the container with every lazy
    CRC-32C audit pending, and every file of the store flushed and evicted
    (``evict``). Returns the starting state for the arm's log line."""
    t0 = time.perf_counter()
    store.close()
    files, nbytes = evict(store)
    return (f"first read (store reopened, audit pending; {files} files, "
            f"{nbytes} B fsynced and evicted in "
            f"{time.perf_counter() - t0:.3f} s)")


# the decided-plan arms of the CNN and LLM phases: (label, run_cold mode,
# audit: "" for an arm that starts from a first read; "landed" for the
# nnv12 arm that follows the sequential arm and starts with the audit
# landed, files evicted)
DECIDED_ARMS = [("decided plan", "nnv12", ""),
                ("decided plan", "sequential", ""),
                ("decided plan, audit landed first", "nnv12", "landed")]


def decided_arm_state(eng, mode: str, audit: str) -> str:
    """The starting state of a decided-plan arm of ``eng``, for its log
    line. An nnv12 arm with no ``audit`` starts from a first read
    (``first_read_state``) and pays the lazy CRC-32C audit inside
    total_s. So does the sequential arm, but its run lands the audit of
    the raw entries (``warm_verify`` over the weighted layers, which reads
    them from disk) before its timer starts; here that audit is landed
    first and timed on its own ("audit s"), so the line shows what the arm
    did not pay. ``audit="landed"`` (the nnv12 arm right after the
    sequential one): the store is not reopened, so the raw entries'
    audit stays landed; the audit of every cache entry the decided plan
    reads (``audit_cached``: ``warm_verify`` never touches them) is landed
    and timed here, then the files are evicted again."""
    store, layers = eng.store, eng.layers
    if audit == "landed":
        if getattr(store, "_reader", None) is None:
            fail("the audit-landed arm must follow the sequential arm, "
                 "with the store still open")
        cached = [(l.spec.name, c.kernel)
                  for l, c in zip(layers, eng.plan.choices) if c.use_cache]
        t0 = time.perf_counter()
        bad = [e for e in cached if not store.audit_cached(*e)]
        cache_s = time.perf_counter() - t0
        if bad:
            fail(f"cache entries failed their CRC-32C audit: {bad}")
        files, nbytes = evict(store)
        return (f"audit landed (raw entries by the sequential arm, the "
                f"store kept open; audit s={cache_s:.3f} for the plan's "
                f"{len(cached)} cache entries; then {files} files, "
                f"{nbytes} B fsynced and evicted); pays no audit")
    start = first_read_state(store)
    if mode != "sequential":
        return start + "; pays the audit"
    t0 = time.perf_counter()
    store.warm_verify(l.spec.name for l in layers if l.spec.weight_shapes)
    return (f"{start}; audit s={time.perf_counter() - t0:.3f} (raw "
            f"entries), landed before the timer, the files left in the "
            f"page cache")


AS_LEFT = "as the previous arm left it"


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def wall_ms(fn, iters=10):
    """Host time of one call of ``fn``, synchronized, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def plan_summary(choices) -> dict:
    summary = {}
    for kern, cached in choices:
        key = f"{kern}/{'cache' if cached else 'raw'}"
        summary[key] = summary.get(key, 0) + 1
    return summary


def materialize(eng, layer, kernel) -> None:
    """Write ``layer``'s cache entry for ``kernel`` unless it exists."""
    if not eng.store.has_cached(layer.spec.name, kernel):
        kern = next(k for k in eng._kernels_for(layer.spec)
                    if k.name == kernel)
        eng.store.write_cached(
            layer.spec.name, kernel,
            kern.transform(eng.store.read_raw(layer.spec.name), layer.spec))


def layer_weights(eng, layer, kernel, cached, dev) -> dict:
    """The weights a run of ``kernel`` executes for ``layer``, as device
    tensors: the cache entry (or the transform of the raw weights), with
    quantized tensors dequantized in numpy (``quant.dequantize_weight``)."""
    import numpy as np

    from repro_torch import bf16, quant

    kern = next(k for k in eng._kernels_for(layer.spec) if k.name == kernel)
    name = layer.spec.name
    entry = (eng.store.read_cached(name, kernel) if cached
             else kern.transform(eng.store.read_raw(name), layer.spec))
    groups, rest = quant.split_groups(entry)
    w = {k: bf16.to_tensor(np.array(v)).to(dev) for k, v in rest.items()}
    for base in groups:
        w[base] = bf16.to_tensor(quant.dequantize_weight(
            entry, base, layer.spec.weight_shapes[base])).to(dev)
    return w


def llm_path(dev, depth: int) -> dict:
    """smollm-360m cold prefill through the engine; returns the launch
    counts of the path's runs (zeroed just before them)."""
    import dataclasses

    import torch

    from repro_torch.checkpoint.integrity import crc32c_backend
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.llm_graph import build_llm_graph
    from repro_torch.core.scheduler import Choice
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"main path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}"
          f"/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} (of 32), "
          f"store_fmt=super")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s, prompt "
          f"{tuple(toks.shape)}")

    with plain_kernels():
        ref_out, _, _ = T.forward(
            T.to_device(params, dev),
            {"tokens": torch.from_numpy(toks).to(dev)}, cfg)
    torch.cuda.synchronize()
    del params
    shape = (1, toks.shape[1], cfg.vocab_size)

    def check_logits(label, out):
        out = out.detach()
        if tuple(out.shape) != shape or out.dtype != torch.float32 \
                or not torch.isfinite(out).all():
            fail(f"{label}: logits {tuple(out.shape)} {out.dtype} or "
                 f"non-finite")
        d = (out - ref_out).abs()
        ok = bool((d <= LLM_ATOL + LLM_RTOL * ref_out.abs()).all())
        print(f"  {label}: logits {shape}, max|d|={d.max().item():.4e} "
              f"max|ref|={ref_out.abs().max().item():.4e} "
              f"within atol {LLM_ATOL} rtol {LLM_RTOL}: {ok}")
        if not ok:
            fail(f"{label}: logits disagree with the all-plain forward")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as tmp:
        t0 = time.perf_counter()
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         device=dev)
        print(f"  engine and store: {time.perf_counter() - t0:.2f} s "
              f"(CRC-32C backend: {crc32c_backend()})")
        t0 = time.perf_counter()
        stats = eng.decide(toks)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"io_interference={stats['io_interference']:.3f} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        print(f"  planned cold read bytes: "
              f"{json.dumps(stats['planned_cold_read_bytes'])}")
        # the bf16 cache of every layer, for the pinned bf16_cast plan
        weighted = [l for l in layers if l.spec.weight_shapes]
        t0 = time.perf_counter()
        for l in weighted:
            materialize(eng, l, "bf16_cast")
        eng.store.maintain()
        raw_b = sum(eng.store.raw_bytes(l.spec.name) for l in weighted)
        cache_b = sum(eng.store.cached_bytes(l.spec.name, "bf16_cast")
                      for l in weighted)
        print(f"  bf16 cache materialized: {time.perf_counter() - t0:.2f} s;"
              f" raw bytes {raw_b}, bf16 cache bytes {cache_b}")
        decided = eng.plan

        def pinned(kernel, cached):
            return replace(decided, choices=[
                Choice(kernel if kernel != "f32_direct"
                       or l.spec.op_type == "tblock" else "direct", cached)
                for l in layers])

        ops.reset_launch_counts()
        outs = {}
        for label, plan, mode, audit in [
                *((lb, None, m, a) for lb, m, a in DECIDED_ARMS),
                ("pinned f32_direct", pinned("f32_direct", False), "nnv12",
                 ""),
                ("pinned bf16_cast cached", pinned("bf16_cast", True),
                 "nnv12", "")]:
            before = ops.launch_counts()
            if plan is not None:
                eng.set_plan(plan)
            start = (decided_arm_state(eng, mode, audit)
                     if plan is None else AS_LEFT)
            r = eng.run_cold(toks, mode=mode)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            print(f"  run_cold [{label}, {mode}; start: {start}]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)}")
            check_logits(f"{label} {mode}", r.output)
            outs[label, mode] = r.output
        nnv12 = outs["decided plan", "nnv12"]
        seq = outs["decided plan", "sequential"]
        print(f"  nnv12 vs sequential: max|d|="
              f"{(nnv12 - seq).abs().max().item():.3e}")
        if not torch.equal(outs["pinned f32_direct", "nnv12"],
                           outs["pinned bf16_cast cached", "nnv12"]):
            fail("the f32_direct and bf16_cast plans differ")
        print("  f32_direct and bf16_cast logits: bitwise equal")
        eng.set_plan(decided)
        before = ops.launch_counts()
        warm = eng.run_warm(toks)
        after = ops.launch_counts()
        print(f"  run_warm: {warm:.4f} s (best of 3), launches="
              f"{json.dumps({k: after[k] - before[k] for k in after if after[k] - before[k]})}")
        counts = ops.launch_counts()
        print(f"  bf16 template launches by path (the runs above): "
              f"{json.dumps(ops.gemm_path_counts())}")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the LLM path: {repairs} "
                 f"{open_breakers}")
        out = {k: counts[k] for k in ("flash_attention", "matmul_bf16")}
        for k, n in out.items():
            if n <= 0:
                fail(f"kernel {k} never launched on the LLM path")
        del eng
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    return out


def llm_lossy_path(dev, depth: int) -> dict:
    """smollm-360m cold prefill on the quantized caches
    (``ColdEngine(allow_lossy=True)``); returns the launch counts of the
    path's runs (zeroed just before them)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.llm_graph import (EmbedDirect, HeadDirect,
                                            TBlockF32Direct, build_llm_graph)
    from repro_torch.core.profiler import SyntheticProfiler
    from repro_torch.core.scheduler import Choice
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"lossy LLM path: {cfg.name} full width, layers={depth} (of 32), "
          f"allow_lossy=True, store_fmt=super")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    del params
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s")
    weighted = [l for l in layers if l.spec.weight_shapes]
    matmul_layers = [l for l in layers if l.spec.op_type in ("tblock",
                                                             "lmhead")]
    shape = (1, toks.shape[1], cfg.vocab_size)
    direct = {"embed": EmbedDirect(), "tblock": TBlockF32Direct(),
              "lmhead": HeadDirect()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lossy_llm_") as tmp:
        t0 = time.perf_counter()
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         allow_lossy=True, device=dev)
        eng.profiler_factory = SyntheticProfiler
        print(f"  engine and store: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        stats = eng.decide(toks, calibrate_interference=False)
        print(f"  decide (SyntheticProfiler): {time.perf_counter() - t0:.2f}"
              f" s, profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        print(f"  planned cold read bytes: "
              f"{json.dumps(stats['planned_cold_read_bytes'])}")
        decided = eng.plan
        t0 = time.perf_counter()
        for l in weighted:
            for kernel in ("bf16_cast", "int8", "int4"):
                if l.spec.op_type != "embed" or kernel == "bf16_cast":
                    materialize(eng, l, kernel)
        eng.store.maintain()
        print(f"  int8, int4 and bf16_cast caches materialized: "
              f"{time.perf_counter() - t0:.2f} s")

        def pinned(kernel):
            return replace(decided, choices=[
                Choice("bf16_cast" if l.spec.op_type == "embed" else kernel,
                       True) for l in layers])

        def plain_forward(plan):
            """All-plain forward on the weights the run reads, quantized
            ones dequantized, each cast to bf16 by the lossless kernels."""
            y = torch.from_numpy(toks).to(dev)
            with plain_kernels():
                for l, c in zip(layers, plan.choices):
                    w = layer_weights(eng, l, c.kernel, c.use_cache, dev)
                    y = direct[l.spec.op_type].execute(w, y, l.spec)
            torch.cuda.synchronize()
            return y

        # each pinned arm twice: the first run reads (and CRC-audits) its
        # extents for the first time, the second finds them read once
        arms = ("bf16_cast", "int8", "int4")
        ops.reset_launch_counts()
        outs, served, matmul_b, model_b = {}, {}, {}, {}
        for label, plan in ([("decided", decided)]
                            + [(a, pinned(a)) for a in arms]
                            + [(f"{a} again", pinned(a)) for a in arms]):
            eng.set_plan(plan)
            before, s0 = ops.launch_counts(), eng.store.bytes_served()
            r = eng.run_cold(toks)
            after = ops.launch_counts()
            served[label] = eng.store.bytes_served() - s0
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            cached = {l.spec.name: c for l, c in zip(layers, plan.choices)}
            matmul_b[label] = sum(
                eng.store.cached_bytes(l.spec.name, cached[l.spec.name].kernel)
                for l in matmul_layers if cached[l.spec.name].use_cache)
            model_b[label] = sum(
                eng.store.cached_bytes(l.spec.name, cached[l.spec.name].kernel)
                for l in weighted if cached[l.spec.name].use_cache)
            print(f"  run_cold [{label}, nnv12]: total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)} bytes_served={served[label]}"
                  f" cache bytes: matmul layers {matmul_b[label]}, "
                  f"whole model {model_b[label]}")
            out = r.output.detach()
            if tuple(out.shape) != shape or out.dtype != torch.float32 \
                    or not torch.isfinite(out).all():
                fail(f"lossy {label}: logits {tuple(out.shape)} {out.dtype} "
                     f"or non-finite")
            ref = plain_forward(plan)
            d = (out - ref).abs()
            ok = bool((d <= LLM_ATOL + LLM_RTOL * ref.abs()).all())
            print(f"    vs all-plain forward on the same weights: "
                  f"max|d|={d.max().item():.4e} "
                  f"max|ref|={ref.abs().max().item():.4e} within atol "
                  f"{LLM_ATOL} rtol {LLM_RTOL}: {ok}")
            if not ok:
                fail(f"lossy {label}: logits disagree with the all-plain "
                     f"forward")
            outs[label] = out
        counts = ops.launch_counts()
        for a in arms:
            if not torch.equal(outs[a], outs[f"{a} again"]):
                fail(f"lossy {a}: two runs of one plan differ")
        print("  each pinned arm's two runs: bitwise equal logits")
        base = outs["bf16_cast"].cpu().numpy().ravel()
        for arm, floor in LOSSY_BYTE_FLOORS.items():
            ratio_mm = matmul_b["bf16_cast"] / max(matmul_b[arm], 1)
            ratio_model = model_b["bf16_cast"] / max(model_b[arm], 1)
            ratio_served = served["bf16_cast"] / max(served[arm], 1)
            corr = float(np.corrcoef(outs[arm].cpu().numpy().ravel(),
                                     base)[0, 1])
            print(f"  {arm} against bf16_cast: matmul-layer cache bytes "
                  f"{ratio_mm:.4f}x below (gate >= {floor}x), whole-model "
                  f"cache bytes {ratio_model:.4f}x, bytes_served "
                  f"{ratio_served:.4f}x, logits correlation {corr:.6f}")
            if ratio_mm < floor:
                fail(f"{arm}: matmul-layer cache bytes only {ratio_mm:.4f}x "
                     f"below bf16_cast (< {floor}x)")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the lossy LLM path: {repairs} "
                 f"{open_breakers}")
        out = {k: counts[k] for k in ("dequant_int8", "dequant_int4")}
        for k in ("dequant_int8", "dequant_int4", "matmul_bf16",
                  "flash_attention"):
            if counts[k] <= 0:
                fail(f"kernel {k} never launched on the lossy LLM path")
        del eng
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    return out


def serving_path(dev, depth: int) -> dict:
    """smollm-360m cold serving: ``ColdServer`` -> ``add_model`` ->
    ``decide`` -> ``cold_start_llm`` (streamed prefill, first token, packs,
    then decode on a ``BatchedServer``); then teacher-forced
    ``decode_step`` against the plain kernels (bf16 cache, int8 cache, a
    32-entry window ring over 48 positions) and a ``BatchedServer`` run
    with slots recycled. Returns the launch counts of the cold start
    (zeroed just before it). Launch counts are checked at the end, so a
    CPU rehearsal runs every part before it stops there."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.llm_graph import build_llm_graph
    from repro_torch.executor.llm_bridge import cold_start_llm
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.executor.server import ColdServer
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.runtime_flags import FLAGS
    from repro_torch.serving import BatchedServer, Request

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"serving path: {cfg.name} full width, layers={depth} (of 32), "
          f"ColdServer -> decide -> cold_start_llm(max_new_tokens=16) -> "
          f"BatchedServer")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s, prompt "
          f"{tuple(toks.shape)}")
    pdev = T.to_device(params, dev)
    del params
    gates = PathGates("serving path")
    gate = gates.check

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        srv = ColdServer(Path(tmp) / "server", device=dev)
        eng = srv.add_model("smollm", layers, store_fmt="super")
        t0 = time.perf_counter()
        stats = srv.decide("smollm", toks)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} plan summary "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        gate(not stats.get("degraded"), f"decide degraded: {stats.get('error')}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = cold_start_llm(eng, cfg, toks[0], max_new_tokens=16,
                             server=srv, model_name="smollm")
        wall = time.perf_counter() - t0
        cold_counts = ops.launch_counts()
        print(f"  bf16 template launches by path (cold start): "
              f"{json.dumps(ops.gemm_path_counts())}")
        n_dec = res.decode_ticks      # decode_step calls after decode-ready
        print(f"  cold_start_llm: wall {wall:.3f} s; first_token_s="
              f"{res.first_token_s:.4f} last_weight_prep_s="
              f"{res.last_weight_prep_s:.4f} decode_prep_s="
              f"{res.decode_prep_s:.4f} decode_ready_s="
              f"{res.decode_ready_s:.4f} overlapped_layers="
              f"{res.overlapped_layers} overlapped_packs="
              f"{res.overlapped_packs} decode_steps={res.decode_steps} "
              f"decode_s={res.decode_s:.4f} "
              f"({res.decode_s * 1e3 / max(n_dec, 1):.3f} ms per decoded "
              f"token over {n_dec} ticks)")
        print(f"  cold run stage_seconds="
              f"{json.dumps(res.run.stage_seconds())}")
        print(f"  tokens: {res.tokens}")
        print(f"  launches: "
              f"{json.dumps({k: n for k, n in cold_counts.items() if n})}")
        gate(res.first_token_before_last_prep,
             "first token not before the last decode prep")
        gate(res.overlapped_layers >= 1, "no weight prep overlapped")
        gate(len(res.tokens) == 16, f"{len(res.tokens)} tokens, not 16")
        gate(res.tokens[0] == res.first_token, "tokens[0] != first_token")
        gate(n_dec == len(res.tokens) - 3,
             f"{n_dec} ticks timed after decode-ready, not "
             f"{len(res.tokens) - 3}")
        gates.launched("cold start", "decode_attention",
                       cold_counts["decode_attention"],
                       depth * res.decode_steps)
        for k in ("flash_attention", "matmul_bf16"):
            gates.launched("cold start", k, cold_counts[k])
        # the streamed prefill's logits against an all-plain forward
        with plain_kernels():
            ref, _, _ = T.forward(
                pdev, {"tokens": torch.from_numpy(toks).to(dev)}, cfg)
        d = (res.run.output - ref).abs()
        ok = bool((d <= LLM_ATOL + LLM_RTOL * ref.abs()).all())
        print(f"  prefill logits vs all-plain forward: max|d|="
              f"{d.max().item():.4e} within atol {LLM_ATOL} rtol "
              f"{LLM_RTOL}: {ok}; first token {res.first_token}, plain "
              f"argmax {int(torch.argmax(ref[0, -1]))}")
        gate(ok, "serving prefill logits disagree with the plain forward")
        budget = srv.budget.snapshot()
        kv_left = sum(n for t, n in budget["by_tag"].items()
                      if t.startswith("kv:"))
        # the packed decode params stay charged, at their own bytes: a
        # sibling worker's warm-state fetch can take them
        packed = sum(int(v.nbytes) for st in srv._packed_state.values()
                     for v in st.values())
        charged = sum(n for t, n in budget["by_tag"].items()
                      if t.startswith("packed:"))
        print(f"  MemoryBudget after close: {json.dumps(budget)} "
              f"(KV reservations left: {kv_left} B; resident "
              f"{srv.resident_bytes()} B; packed decode params {packed} B, "
              f"charged {charged} B)")
        gate(packed > 0 and charged == packed,
             "the packed decode params are not charged at their bytes")
        gate(kv_left == 0
             and budget["used"] == srv.resident_bytes() + packed,
             "the KV reservation did not return to the budget")
        repairs = eng.repairs.counts()
        gate(not repairs.get("kernel_demoted") and not eng.breaker.open_keys(),
             f"kernels were demoted on the serving path: {repairs}")
        del srv, eng, res
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()

    # teacher-forced decode_step: kernels against the plain versions
    S, B = 48, 2
    tf_toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S))).to(dev)

    def teacher_forced(c, plain):
        state = T.init_decode_state(c, B, S, device=dev)
        outs = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for t in range(S):
                lg, state = T.decode_step(pdev, state,
                                          {"tokens": tf_toks[:, t:t + 1]}, t, c)
                outs.append(lg[:, 0])
        torch.cuda.synchronize()
        return torch.stack(outs, 1), state

    for arm, c, int8 in [("bf16 cache", cfg, False),
                         ("int8 cache", cfg, True),
                         ("window-32 ring", cfg.with_sliding_window(32), False)]:
        saved = FLAGS["kv_cache_int8"]
        FLAGS["kv_cache_int8"] = int8
        try:
            before = ops.launch_counts()["decode_attention"]
            t0 = time.perf_counter()
            got, state = teacher_forced(c, False)
            t_k = time.perf_counter() - t0
            launched = ops.launch_counts()["decode_attention"] - before
            t0 = time.perf_counter()
            want, _ = teacher_forced(c, True)
            t_p = time.perf_counter() - t0
        finally:
            FLAGS["kv_cache_int8"] = saved
        d = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (d <= LLM_ATOL + LLM_RTOL * want.abs()).all())
        print(f"  teacher-forced [{arm}]: {S} steps B={B} cache "
              f"{tuple(state['k'].shape)} {state['k'].dtype}; logits max|d|="
              f"{d.max().item():.4e} max|ref|={want.abs().max().item():.4e} "
              f"within atol {LLM_ATOL} rtol {LLM_RTOL}: {ok}; "
              f"{t_k * 1e3 / S:.3f} ms/step (plain {t_p * 1e3 / S:.3f})")
        gate(ok, f"teacher-forced {arm}: logits disagree with the plain run")
        gates.launched(f"teacher-forced {arm}", "decode_attention",
                       launched, depth * S)

    # where a decode step's time goes: device busy time under the profiler
    # (B=1 at the cold start's cache length; reported, not gated)
    state = T.init_decode_state(cfg, 1, 82, device=dev)
    one = tf_toks[:1]
    for t in range(4):  # warm
        T.decode_step(pdev, state, {"tokens": one[:, t:t + 1]}, t, cfg)
    profile_steps("8 decode steps B=1 W=82", lambda i: T.decode_step(
        pdev, state, {"tokens": one[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_",))

    # BatchedServer: 6 greedy requests through 4 slots (recycled)
    got, steps, dt, counts, picks = batched_run(pdev, cfg, dev, plain=False)
    want, _, dt_p, _, picks_p = batched_run(pdev, cfg, dev, plain=True)
    gate(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
         "a batched request did not finish with its token count")
    gates.launched("batched", "decode_attention", counts["decode_attention"],
                   depth * steps)
    gates.finish()
    return {"decode_attention": cold_counts["decode_attention"]}


@contextlib.contextmanager
def routing_log(replay=None):
    """Record every MoE ``route`` call's top-k experts, (T, k) on their
    device (no host sync), in call order. With ``replay`` (such a record), each call takes the
    recorded experts in place of its own top k, weighted by its own
    probabilities renormalized over them: two runs then make the same
    discrete choices and differ only by rounding."""
    from repro_torch.models import moe as MOE

    log = []
    route = MOE.route

    def recording(xf, router, cfg):
        probs, top_p, top_e = route(xf, router, cfg)
        if replay is not None:
            top_e = replay[len(log)].to(probs.device)
            top_p = probs.gather(1, top_e)
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        log.append(top_e.clone())
        return probs, top_p, top_e

    MOE.route = recording
    try:
        yield log
    finally:
        MOE.route = route


def routing_agreement(a, b):
    """Two runs' routing logs (lists of (T, k), the same calls in the same
    order): the share of (token, expert) assignments that agree, and (T,)
    True where a token took the same experts in every call."""
    same = total = 0
    alike = None
    for x, y in zip(a, b, strict=True):
        hit = (x[:, :, None] == y[:, None, :]).any(-1)   # x's expert in y's
        same, total = same + int(hit.sum()), total + hit.numel()
        alike = hit.all(-1) if alike is None else alike & hit.all(-1)
    return same / max(total, 1), alike


def logits_gate(got, ref):
    """(rows within atol/rtol of ``ref``, (rows,) bool; max|d|; max|ref|)
    over the logits' rows (every leading index)."""
    d = (got - ref).abs()
    ok = (d <= LLM_ATOL + LLM_RTOL * ref.abs()).reshape(
        -1, ref.shape[-1]).all(dim=1)
    return ok.cpu(), d.max().item(), ref.abs().max().item()


class PathGates:
    """A path's gates, reported together at its end (``finish``), so that a
    CPU rehearsal runs every part of the path first; ``main`` sums the
    launch counts of the path's main runs."""

    def __init__(self, name: str):
        self.name, self.failures, self.main = name, [], {}

    def check(self, ok, msg: str) -> None:
        if not ok:
            self.failures.append(msg)

    def launched(self, label, kernel, n, expected=None) -> None:
        """``kernel`` launched ``n`` times in ``label``: at least once, and
        ``expected`` times where that is given."""
        self.check(n > 0 and expected in (None, n),
                   f"{label}: {kernel} launched {n} times"
                   + ("" if expected is None else f", expected {expected}"))

    def add(self, counts) -> None:
        for k, n in counts.items():
            self.main[k] = self.main.get(k, 0) + n

    def logits(self, label, got, ref) -> None:
        """Every row of ``got`` within the LLM gate of ``ref``."""
        import torch

        ok, dmax, rmax = logits_gate(got, ref)
        print(f"  {label}: logits {tuple(got.shape)} max|d|={dmax:.4e} "
              f"max|ref|={rmax:.4e}; rows within atol {LLM_ATOL} rtol "
              f"{LLM_RTOL}: {int(ok.sum())}/{len(ok)}")
        self.check(bool(torch.isfinite(got).all()) and bool(ok.all()),
                   f"{label}: logits leave the gate")

    def relative(self, label, got, ref, tol=PATH_TOL) -> None:
        """``got`` within ``tol`` of ``ref`` relative to max|ref|: the f32
        gate (the bf16 LLM gate would pass a bf16 or TF32 product)."""
        import torch

        rmax = ref.abs().max().item()
        rel = (got - ref).abs().max().item() / max(rmax, 1e-30)
        print(f"  {label}: logits {tuple(got.shape)} max|d|/max|ref|="
              f"{rel:.3e} (max|ref|={rmax:.4e}), gate {tol}")
        self.check(bool(torch.isfinite(got).all()) and rel <= tol,
                   f"{label}: logits leave the f32 gate ({rel:.3e} > {tol})")

    def finish(self) -> None:
        if self.failures:
            fail(f"{self.name}: " + "; ".join(self.failures))


def moe_path(dev, depth: int) -> dict:
    """granite-moe-3b-a800m at full width, ``depth`` layers, bf16, random
    weights from seed 0 drawn on the card: ``forward`` on a 512-token
    prompt with the kernels against the all-plain forward; one MoE layer
    on identical inputs, kernel against plain; decode by steps against
    ``forward`` on a 32-token prompt; a ``BatchedServer`` run against the
    plain kernels' run. A bf16 difference upstream of the f32 router can
    flip a near-tie between experts, and a flipped token's hidden state
    reaches the other tokens through attention; so each whole-model logits
    gate compares two runs under the same routing (the second replays the
    first's experts), and the free-running kernel and plain forwards must
    share ``ROUTE_AGREE`` of their (token, expert) assignments. Last, the
    model in f32 at ``MOE_F32_DEPTH`` layers (a cut): ``forward`` on the
    512-token prompt against the all-plain f32 forward under the same
    routing (within ``PATH_TOL`` of max|ref|, the f32 gate), so that
    ``gmm_blocks``' f32 entry runs on the path. Returns
    the launch counts of the main runs (the kernel forward, the decode
    steps, the batched server and the f32 forward), each zeroed just
    before it; launch gates are checked last, so a CPU rehearsal runs
    every part."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=depth)
    print(f"moe path: {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
          f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, vocab "
          f"{cfg.vocab_size}), layers={depth} (of 32), {cfg.dtype}: forward, "
          f"decode_step, BatchedServer")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"  weights: {n_params} params drawn on {dev} in "
          f"{time.perf_counter() - t0:.2f} s")
    gates = PathGates("moe path")

    def agreement(label, a, b):
        share, alike = routing_agreement(a, b)
        print(f"  routing, {label}: {share:.4f} of (token, expert) "
              f"assignments agree; {int(alike.sum())}/{len(alike)} tokens "
              f"took the same experts in every layer")
        return share

    # forward on a 512-token prompt: kernels against the all-plain forward
    S = 512
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, S))).to(dev)
    with routing_log() as klog:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, aux, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = ops.launch_counts()
    gates.add(counts)
    print(f"  bf16 template launches by path (forward): "
          f"{json.dumps(ops.gemm_path_counts())}")
    with routing_log() as plog, plain_kernels():
        t0 = time.perf_counter()
        _, ref_aux, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    with routing_log(replay=klog), plain_kernels():
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
    print(f"  forward (1, {S}): {t_k * 1e3:.1f} ms with the kernels "
          f"(first call), {t_p * 1e3:.1f} ms all-plain; aux {aux.item():.5f} "
          f"(plain {ref_aux.item():.5f}); launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    C = MOE.capacity(S, cfg)
    dropped = sum(int((torch.bincount(e.reshape(-1), minlength=cfg.num_experts)
                       - C).clamp_min(0).sum()) for e in klog)
    print(f"  capacity C={C} a block: {dropped} of {S * cfg.top_k * depth} "
          f"(token, expert) assignments dropped over the {depth} layers")
    share = agreement("forward, kernels vs all-plain", klog, plog)
    gates.check(share >= ROUTE_AGREE, f"only {share:.4f} of the forward's "
                f"routing assignments agree with the all-plain forward's "
                f"(< {ROUTE_AGREE})")
    gates.logits(f"forward (1, {S}) vs all-plain under the kernels' routing",
                 logits, ref)
    gates.launched("forward", "gmm_blocks", counts["gmm_blocks"], 3 * depth)
    gates.launched("forward", "flash_attention", counts["flash_attention"],
                   depth)
    # the f32 router GEMM: one matmul launch a layer
    gates.launched("forward", "matmul", counts["matmul"], depth)
    del logits, ref
    profile_steps(f"forward (1, {S})", lambda i: T.forward(
        params, {"tokens": toks}, cfg), 1,
        extra=("gemm", "flash", "fa_bf16"))

    # one MoE layer on identical inputs (routing identical by construction)
    bp = T._layer(params["blocks"], 0)["moe"]
    xn = torch.randn((1, S, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(torch.bfloat16)
    with routing_log() as klog:
        y_k, _ = MOE.moe_apply(bp, xn, cfg)
    with routing_log() as plog, plain_kernels():
        y_p, _ = MOE.moe_apply(bp, xn, cfg)
    torch.cuda.synchronize()
    rel = ((y_k.float() - y_p.float()).abs().max()
           / y_p.float().abs().max().clamp_min(1e-30)).item()
    share, _ = routing_agreement(klog, plog)
    ms_k = wall_ms(lambda: MOE.moe_apply(bp, xn, cfg))
    with plain_kernels():
        ms_p = wall_ms(lambda: MOE.moe_apply(bp, xn, cfg))
    print(f"  one MoE layer on identical inputs (1, {S}, {cfg.d_model}), "
          f"C={MOE.capacity(S, cfg)}: max|d|/max|plain|={rel:.3e} (tol "
          f"{KERNEL_TOL['bfloat16']}); routing {share:.4f} alike; "
          f"{ms_k:.3f} ms with the kernels, {ms_p:.3f} ms plain")
    gates.check(rel <= KERNEL_TOL["bfloat16"]
                and bool(torch.isfinite(y_k).all()),
                f"one MoE layer disagrees with its plain version ({rel:.3e})")

    # decode by steps against forward on a short prompt: free-running for
    # the launch counts and the routing agreement, then under the
    # forward's routing for the logits gate. Decode routes one token at a
    # time and never fills a block (C = 8), while a forward drops the
    # tokens past C; so this forward runs with a capacity factor of E/k,
    # which gives C >= T and drops nothing (decode's C is 8 either way)
    Sd = 32
    dtoks = toks[:, :Sd]
    ncfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                               / cfg.top_k)
    with routing_log() as flog:
        fl, _, _ = T.forward(params, {"tokens": dtoks}, ncfg)
    # the forward's choices in decode's call order (step-major)
    replay = [flog[l][t:t + 1] for t in range(Sd) for l in range(depth)]

    def decode(log_replay=None):
        state = T.init_decode_state(ncfg, 1, Sd, device=dev)
        outs = []
        with routing_log(replay=log_replay) as dlog:
            for t in range(Sd):
                lg, state = T.decode_step(
                    params, state, {"tokens": dtoks[:, t:t + 1]}, t, ncfg)
                outs.append(lg[:, 0])
        torch.cuda.synchronize()
        return torch.stack(outs, 1), [torch.cat(dlog[l::depth])
                                      for l in range(depth)]

    ops.reset_launch_counts()
    dec, dlog = decode()
    counts = ops.launch_counts()
    gates.add(counts)
    print(f"  bf16 template launches by path (decode, {Sd} steps): "
          f"{json.dumps(ops.gemm_path_counts())}")
    ok, dmax, _ = logits_gate(dec, fl)
    print(f"  decode by steps, free-running ({Sd} tokens, kernels): max|d| "
          f"vs forward {dmax:.4e}, rows within the gate {int(ok.sum())}/"
          f"{len(ok)}")
    agreement("decode by steps vs forward", dlog, flog)
    gates.logits(f"decode by steps vs forward ({Sd} tokens, kernels) under "
                 f"the forward's routing", decode(replay)[0], fl)
    gates.launched("decode", "gmm_blocks", counts["gmm_blocks"],
                   3 * depth * Sd)
    gates.launched("decode", "decode_attention", counts["decode_attention"],
                   depth * Sd)
    gates.launched("decode", "matmul", counts["matmul"], depth * Sd)

    # where a decode step's time goes (B=1; reported, not gated)
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps("8 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_", "gemm_f32"))

    # BatchedServer: the serving path's request mix
    got, steps, dt, counts, picks = batched_run(params, cfg, dev,
                                                plain=False)
    gates.add(counts)
    with routing_log() as blog:
        want, _, dt_p, _, picks_p = batched_run(params, cfg, dev, plain=True)
    gates.check(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
                "a batched request did not finish with its token count")
    print(f"  batched launches: "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    gates.launched("batched", "gmm_blocks", counts["gmm_blocks"],
                   3 * depth * steps)
    gates.launched("batched", "decode_attention", counts["decode_attention"],
                   depth * steps)
    gates.launched("batched", "matmul", counts["matmul"], depth * steps)
    # why the kernels' tokens leave the plain run's: the kernels' run
    # again, replaying the plain run's routing (reported, not gated; its
    # launches are not counted)
    with routing_log(replay=blog):
        got_r, _, dt, _, picks = batched_run(params, cfg, dev, plain=False)
    print("  the kernels' batched run again, replaying the plain run's "
          "routing:")
    report_batched(got_r, want, steps, dt, dt_p, picks, picks_p)
    del params, state
    torch.cuda.empty_cache()

    # the f32 entry of gmm_blocks on the path: the model in f32 at full
    # width, its depth cut to MOE_F32_DEPTH layers (to spare the run's
    # time: the bf16 runs above cover the whole depth), forward on the
    # 512-token prompt against the all-plain f32 forward under the
    # kernels' routing
    c32 = dataclasses.replace(cfg, dtype="float32", num_layers=MOE_F32_DEPTH)
    p32 = T.init_params(c32, torch.Generator(device=dev).manual_seed(0))
    with routing_log() as klog:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(p32, {"tokens": toks}, c32)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = ops.launch_counts()
    gates.add(counts)
    with routing_log(replay=klog), plain_kernels():
        ref, _, _ = T.forward(p32, {"tokens": toks}, c32)
    print(f"  f32 forward (1, {S}), layers={MOE_F32_DEPTH} (of 32, a cut): "
          f"{t_k * 1e3:.1f} ms with the kernels (first call); launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    gates.relative(f"f32 forward (1, {S}) vs all-plain under the kernels' "
                   f"routing", logits, ref)
    gates.launched("f32 forward", "gmm_blocks", counts["gmm_blocks"],
                   3 * MOE_F32_DEPTH)
    gates.launched("f32 forward", "flash_attention",
                   counts["flash_attention"], MOE_F32_DEPTH)
    gates.launched("f32 forward", "matmul", counts["matmul"])
    del p32, logits, ref
    print(f"  moe path launches (forward + decode steps + batched + f32 "
          f"forward): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {"gmm_blocks": gates.main["gmm_blocks"],
            "matmul": gates.main["matmul"]}


def ssm_path(dev, depth: int) -> dict:
    """mamba2-2.7b at full width, ``depth`` layers, random weights from
    seed 0 drawn on the card. In bf16, the served precision: ``forward`` on
    a 1024-token prompt with the kernels, each layer held to its plain
    version on the same input (lockstep through the layers), the whole
    model's difference from the all-plain forward reported (this
    random-weight model amplifies a rounding-size difference about 25-fold
    over 64 layers, so no logits gate holds between two bf16 roundings of
    it), and a ``BatchedServer`` run against the plain kernels' run. In f32, where a rounding difference stays small: the
    kernels' forward against the all-plain forward, and decode by steps
    against ``forward`` over two 256-token chunks (the kernel's chunked
    scan against the recurrence of ``ssd_decode_step``), both within the
    LLM gate. Returns the launch counts of the main runs (both forwards,
    the decode steps and the batched server), each zeroed just before it;
    launch gates are checked last."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    base = dataclasses.replace(get_config("mamba2-2.7b"), num_layers=depth)
    print(f"ssm path: {base.name} full width (d_model {base.d_model}, inner "
          f"{base.ssm_inner}, {base.ssm_heads} heads of P {base.ssm_head_dim},"
          f" N {base.ssm_state}, chunk {base.ssm_chunk}, vocab "
          f"{base.vocab_size}), layers={depth} (of 64): forward, decode_step,"
          f" BatchedServer in bf16; forward and decode against forward in "
          f"f32")
    gates = PathGates("ssm path")

    def draw(dtype):
        c = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        p = T.init_params(c, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        print(f"  {dtype} weights: {sum(t.numel() for t in leaves(p))} "
              f"params drawn on {dev} in {time.perf_counter() - t0:.2f} s")
        return c, p

    def counted_forward(params, cfg, toks):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        gates.add(counts)
        print(f"  bf16 template launches by path ({cfg.dtype} forward): "
              f"{json.dumps(ops.gemm_path_counts())}")
        print(f"  {cfg.dtype} forward {tuple(toks.shape)}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms with the kernels "
              f"(first call); launches "
              f"{json.dumps({k: n for k, n in counts.items() if n})}")
        gates.launched(f"{cfg.dtype} forward", "ssd_scan",
                       counts["ssd_scan"], depth)
        if cfg.dtype == "float32":  # six projections a layer, the tied head
            gates.launched(f"{cfg.dtype} forward", "matmul", counts["matmul"],
                           6 * depth + 1)
        return logits

    S = 1024
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.vocab_size, size=(1, S))).to(dev)

    # -- bf16 ----------------------------------------------------------------
    cfg, params = draw("bfloat16")
    logits = counted_forward(params, cfg, toks)
    with plain_kernels():
        t0 = time.perf_counter()
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    _, dmax, rmax = logits_gate(logits, ref)
    print(f"  bf16 forward (1, {S}) vs all-plain ({t_p * 1e3:.1f} ms): "
          f"max|d|={dmax:.4e} max|ref|={rmax:.4e} (reported, not gated)")
    gates.check(bool(torch.isfinite(logits).all()),
                "bf16 forward: non-finite")
    del logits, ref
    # each layer against its plain version on the same input, in lockstep
    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    x = params["embed"][toks]
    worst = (0.0, -1)
    for i in range(depth):
        bp = T._layer(params["blocks"], i)
        y, _ = T._mamba_block_seq(bp, x, cfg)
        with plain_kernels():
            want, _ = T._mamba_block_seq(bp, x, cfg)
        worst = max(worst, (rel(y, want), i))
        x = y
    print(f"  bf16 layers in lockstep, each kernel layer against its plain "
          f"version on the same input: worst max|d|/max|plain| "
          f"{worst[0]:.3e} (layer {worst[1]}, tol {KERNEL_TOL['bfloat16']})")
    gates.check(worst[0] <= KERNEL_TOL["bfloat16"],
                f"bf16 layer {worst[1]} disagrees with its plain version "
                f"({worst[0]:.3e})")
    profile_steps(f"bf16 forward (1, {S})", lambda i: T.forward(
        params, {"tokens": toks}, cfg), 1, extra=("ssd",))
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps("8 bf16 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8)
    got, steps, dt, counts, picks = batched_run(params, cfg, dev,
                                                plain=False)
    gates.add(counts)
    want, _, dt_p, _, picks_p = batched_run(params, cfg, dev, plain=True)
    gates.check(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
                "a batched request did not finish with its token count")
    print(f"  batched launches: "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    # six projections a layer and the tied head, one launch each a step
    gates.launched("batched", "matmul_bf16", counts["matmul_bf16"],
                   (6 * depth + 1) * steps)
    del params, state
    torch.cuda.empty_cache()

    # -- f32 -----------------------------------------------------------------
    cfg, params = draw("float32")
    logits = counted_forward(params, cfg, toks)
    with plain_kernels():
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
    gates.logits(f"f32 forward (1, {S}) vs all-plain", logits, ref)
    del logits, ref
    Sd = 2 * cfg.ssm_chunk
    fl = counted_forward(params, cfg, toks[:, :Sd])
    state = T.init_decode_state(cfg, 1, Sd, device=dev)
    outs = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(Sd):
        lg, state = T.decode_step(params, state, {"tokens": toks[:, t:t + 1]},
                                  t, cfg)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    gates.add(counts)
    print(f"  f32 decode: {Sd} steps B=1 in {time.perf_counter() - t0:.2f} s; "
          f"launches {json.dumps({k: n for k, n in counts.items() if n})}")
    gates.logits(f"f32 decode by steps vs forward ({Sd} tokens, two chunks)",
                 torch.stack(outs, 1), fl)
    gates.launched("f32 decode", "matmul", counts["matmul"],
                   (6 * depth + 1) * Sd)
    profile_steps("8 f32 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, Sd + i:Sd + i + 1]}, Sd + i, cfg),
        8, extra=("gemm_f32",))
    print(f"  ssm path launches (forwards + decode steps + batched): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {"ssd_scan": gates.main["ssd_scan"],
            "matmul": gates.main["matmul"]}


# the hand-written kernel each CNN registry kernel launches, once a layer
# per forward (``direct`` convs run cuDNN, the reference's lax.conv)
CNN_KERNELS = {("conv2d", "im2col_sgemm"): "matmul",
               ("conv2d", "winograd_f2x3"): "winograd_tile_matmul",
               ("linear", "direct"): "matmul",
               ("linear", "packed"): "matmul_packed"}


def cnn_kernels(layers, choices) -> dict:
    """The hand-written kernels a CNN plan's choices launch, with their
    launches per forward."""
    out = {}
    for l, c in zip(layers, choices):
        k = CNN_KERNELS.get((l.spec.op_type, c.kernel))
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def switching_path(card, eng, layers, x_np, decided, im2col_pin,
                   check_output) -> dict:
    """``ContinuousSession`` (paper §3.5) on resnet50@224: K_cold is the
    decided plan, or the pinned im2col plan where the decided plan already
    is K_warm on every weighted layer; ``cold_infer`` from a first read,
    then ``warm_infer(wait=True)`` twice against ``run_warm``. Returns the
    launch counts of the session's three inferences."""
    from repro_torch.core.switching import ContinuousSession
    from repro_torch.kernels import ops

    print(f"continuous mode: ContinuousSession on resnet50 image=224 "
          f"width=1.0 ({card})")
    warm = eng.warm_best_choices()
    weighted = [i for i, l in enumerate(layers) if l.spec.weight_shapes]
    if all(decided.choices[i].kernel == warm[i].kernel for i in weighted):
        eng.set_plan(replace(decided, choices=im2col_pin))
        label = "pinned im2col+direct (the decided plan is K_warm)"
    else:
        eng.set_plan(decided)
        label = "decided plan"
    plan = eng.plan
    moves = [layers[i].spec.name for i in weighted
             if plan.choices[i].kernel != warm[i].kernel]
    print(f"  K_cold: {label}; K_warm differs on {len(moves)} of "
          f"{len(weighted)} weighted layers "
          f"({json.dumps(plan_summary([(warm[i].kernel, False) for i in weighted]))})")
    t_warm = eng.run_warm(x_np)
    print(f"  run_warm: {t_warm:.4f} s (best of 3)")
    start = decided_arm_state(eng, "nnv12", "")
    ops.reset_launch_counts()
    sess = ContinuousSession(eng)
    r1 = sess.cold_infer(x_np)
    t0 = time.perf_counter()
    r2 = sess.warm_infer(x_np, wait=True)
    prep_wait = time.perf_counter() - t0 - r2.total_s
    r3 = sess.warm_infer(x_np, wait=True)
    counts = ops.launch_counts()
    switched = sorted(sess.warm_weights)
    print(f"  cold_infer [start: {start}]: total_s={r1.total_s:.4f} "
          f"stage_seconds={json.dumps(r1.stage_seconds())}")
    for n, r in (("2nd", r2), ("3rd", r3)):
        print(f"  warm_infer {n} (wait=True): total_s={r.total_s:.4f}, "
              f"{r.total_s / t_warm:.3f}x run_warm {t_warm:.4f} s")
    print(f"  switched {len(switched)} of {len(moves)} layers (the 2nd "
          f"warm_infer first waited {prep_wait:.4f} s for the warm preps); "
          f"launches={json.dumps({k: n for k, n in counts.items() if n})}")
    for n, r in (("cold_infer", r1), ("2nd warm_infer", r2),
                 ("3rd warm_infer", r3)):
        check_output(f"ContinuousSession {n}", r.output)
    if not switched:
        fail("ContinuousSession switched no layer")
    if switched != sorted(moves):
        fail(f"ContinuousSession switched {switched}, not {sorted(moves)}")
    used = set(cnn_kernels(layers, plan.choices)) | set(cnn_kernels(
        [l for l in layers if l.spec.name in switched],
        [c for l, c in zip(layers, warm) if l.spec.name in switched]))
    for k in sorted(used):
        if counts[k] <= 0:
            fail(f"kernel {k} never launched in the ContinuousSession runs")
    eng.set_plan(decided)
    return {k: counts[k] for k in used}


# the fleet phase's workers: an SD-card-class edge disk emulated under
# every local read (``--sim-disk-bytes-per-s``); the pinned plan is decided
# under it, so its read costs are the disk's
FLEET_DISK_BYTES_PER_S = 25e6
# the SIGKILL lands this long after the front door dispatched the request
# (the cold start it interrupts takes over a second at the disk's rate)
FLEET_KILL_AFTER_S = 0.1
FLEET_MODEL = dict(name="resnet50", image=224, width=1.0, classes=100,
                   seed=0)
FLEET_WORKERS = ("w0", "w1")


def fleet_plan(root, x_np, device, model):
    """The fleet's one plan: ``decide()`` with measured profiles, as a
    worker would, under the workers' emulated disk (an ``IOEngine`` of its
    own), written into every worker's store before ``add_model`` so each
    worker and restart serves it. Returns the deciding engine."""
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.scheduler import transfer_estimate
    from repro_torch.ioengine import IOEngine
    from repro_torch.models.cnn import build_cnn

    layers, _ = build_cnn(**model)
    io = IOEngine()
    io.set_sim_read_bandwidth(FLEET_DISK_BYTES_PER_S)
    try:
        eng = ColdEngine(layers, root / "plan", store_fmt="super",
                         io_engine=io, device=device)
        stats = eng.decide(x_np, n_little=2)
    finally:
        io.close()
    plan_json = (root / "plan" / "plan.json").read_text()
    for wid in FLEET_WORKERS:
        d = root / "fd" / wid / model["name"]
        d.mkdir(parents=True)
        (d / "plan.json").write_text(plan_json)
    summary = plan_summary((c.kernel, c.use_cache) for c in eng.plan.choices
                           if c.kernel != "fn")
    print(f"  pinned plan (measured, under the emulated disk): decide "
          f"{stats['plan_generation_s']:.2f} s, io_interference="
          f"{stats['io_interference']:.3f} est_makespan_s="
          f"{stats['est_makespan_s']:.6f} against the transfer estimate "
          f"{transfer_estimate(eng.store.model_bytes()):.6f} s of the "
          f"model's {eng.store.model_bytes()} B over an unmeasured link; "
          f"{json.dumps(summary)}")
    return eng


def fleet_path(card, x_np, ref_out, check_output, device="cuda",
               model=FLEET_MODEL) -> dict:
    """``FrontDoor(n_workers=2, device="cuda")`` serving resnet50@224 on one
    pinned measured plan: a SIGKILL mid cold start fails over to the
    sibling, which serves it from disk; the victim restarts; a cold start
    pinned to it races the sibling's RAM; then one warm run on each.
    Outputs bitwise equal across the workers. Returns the launches of the
    served requests (each result carries its own request's), which must be
    the plan's launches per forward times the forwards served. ``device``
    and ``model`` (``build_cnn``'s arguments) let the phase be rehearsed
    on the CPU at a small size."""
    import numpy as np
    import torch

    from repro_torch.executor.frontdoor import FrontDoor

    print(f"fleet: FrontDoor(n_workers=2, device='cuda') serving resnet50 "
          f"image=224 width=1.0, edge disk "
          f"{FLEET_DISK_BYTES_PER_S / 1e6:g} MB/s ({card})")
    served = []

    def show(label, res):
        served.append(res)
        peer = res.get("peer") or {}
        print(f"  {label}: worker {res['worker']} (pid {res['pid']}) "
              f"warm={res['warm']} total_s={res['total_s']:.4f} peer "
              f"layers={peer.get('layers_fetched', 0)} "
              f"bytes={peer.get('bytes_fetched', 0)} "
              f"won={peer.get('won', 0)} launches="
              f"{json.dumps({k: n for k, n in res['launches'].items() if n})}")

    def wait(cond, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.02)
        fail(f"fleet: timed out waiting for {what}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        pinned = fleet_plan(Path(tmp), x_np, device, model)
        fd = FrontDoor(Path(tmp) / "fd", n_workers=len(FLEET_WORKERS),
                       device=device, spawn_timeout_s=300.0,
                       worker_args={"store_fmt": "super",
                                    "sim_disk_bytes_per_s":
                                        FLEET_DISK_BYTES_PER_S})
        try:
            t0 = time.perf_counter()
            fd.start()
            t1 = time.perf_counter()
            fd.add_model("resnet50", "repro_torch.models.cnn:build_cnn",
                         **model)
            t2 = time.perf_counter()
            print(f"  spawn (CUDA context, kernel libraries) {t1 - t0:.2f} "
                  f"s; add_model on both workers (build, store, the pinned "
                  f"plan's cache) {t2 - t1:.2f} s")
            # SIGKILL mid cold start: failover to the sibling, from disk
            req = fd.request("resnet50", x_np, deadline_s=300.0,
                             worker="w0")
            wait(lambda: req.worker is not None, 60, "the first dispatch")
            time.sleep(FLEET_KILL_AFTER_S)
            fd.kill_worker("w0")
            t_kill = time.perf_counter()
            disk = req.result(timeout=300)
            show(f"cold start after SIGKILL of w0 {t_kill - t2:.2f} s in "
                 f"(failover, from disk; request wall "
                 f"{time.perf_counter() - t2:.2f} s)", disk)
            if disk["worker"] != "w1" or disk["warm"] or disk["peer"]:
                fail(f"fleet: the failover was not a cold start on w1: "
                     f"{disk['worker']} warm={disk['warm']}")
            check_output("fleet failover (w1, from disk)",
                         torch.from_numpy(disk["output"]).to(ref_out.device))
            wait(lambda: fd.health()["workers"]["w0"]["alive"]
                 and "resnet50" in fd._workers["w0"].ready_models, 300,
                 "w0's restart")
            h = fd.health()
            print(f"  w0 restarted {time.perf_counter() - t_kill:.2f} s "
                  f"after the kill: stats={json.dumps(h['stats'])}")
            left = (sum(w["in_flight"] for w in h["workers"].values()),
                    sum(h["queues"].values()))
            if h["stats"]["worker_restarts"] < 1 \
                    or h["stats"]["failovers"] < 1 or left != (0, 0):
                fail(f"fleet: restart/failover/leftovers wrong: {h}")
            # the restarted w0 cold-starts racing w1's RAM
            wait(lambda: "resnet50" in (fd._workers["w1"].health.get(
                "resident") or ()), 60, "w1's residency")
            raced = fd.request("resnet50", x_np, deadline_s=300.0,
                               worker="w0").result(timeout=300)
            show("cold start raced against w1's RAM", raced)
            peer = raced.get("peer") or {}
            if raced["worker"] != "w0" or raced["warm"] \
                    or peer.get("layers_fetched", 0) <= 0 \
                    or peer.get("crc_failures"):
                fail(f"fleet: the raced cold start took no peer layer: "
                     f"{raced['worker']} warm={raced['warm']} {peer}")
            if not np.array_equal(raced["output"], disk["output"]):
                fail("fleet: the peer-raced output differs from the "
                     "disk-served one")
            for wid in FLEET_WORKERS:
                again = fd.request("resnet50", x_np, deadline_s=300.0,
                                   worker=wid).result(timeout=300)
                show(f"warm run on {wid}", again)
                if not again["warm"] or not np.array_equal(
                        again["output"], disk["output"]):
                    fail(f"fleet: warm run on {wid} not warm or not "
                         f"bitwise equal")
            print(f"  outputs bitwise equal across workers, after the "
                  f"failover, peer- and disk-served")
        finally:
            fd.shutdown()
        per_forward = cnn_kernels(pinned.layers, pinned.plan.choices)
        counts = {k: sum(r["launches"].get(k, 0) for r in served)
                  for k in per_forward}
        print(f"  requests' launches {json.dumps(counts)}: "
              f"{json.dumps(per_forward)} a forward x {len(served)} "
              f"forwards served")
        for k, n in per_forward.items():
            if counts[k] != n * len(served):
                fail(f"fleet: {k} launched {counts[k]} times in the served "
                     f"requests, not {n} x {len(served)}")
        return counts


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)

    from repro_torch import quant
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.profiler import SyntheticProfiler
    from repro_torch.core.registry import ConvDirect
    from repro_torch.core.scheduler import Choice
    from repro_torch.device import resolve_device, set_f32_precision
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import (StageEngine, reset_io_engine,
                                      reset_stage_engine)
    from repro_torch.kernels import _native, ops
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.attention import (decode_attention_plain,
                                               flash_attention_plain,
                                               plan_decode, plan_flash)
    from repro_torch.kernels.attention import visible as attn_visible
    from repro_torch.kernels.conv_winograd import winograd_tile_matmul_plain
    from repro_torch.kernels.gmm import gmm_blocks_plain
    from repro_torch.kernels.matmul import (matmul_packed_plain, matmul_plain,
                                            plan_bf16_gemm, plan_f32_gemm)
    from repro_torch.kernels.ssd import plan_ssd, ssd_scan_plain
    from repro_torch.models.cnn import build_cnn

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)
    dev = resolve_device("cuda")
    set_f32_precision()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name else "sxm"]
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    # the port carries bf16 without ml_dtypes; report whether this machine
    # has it, without importing it
    try:
        ml_dtypes = f"installed {importlib.metadata.version('ml_dtypes')}"
    except importlib.metadata.PackageNotFoundError:
        ml_dtypes = "not installed"
    print(f"ml_dtypes: {ml_dtypes} (not used by the port)")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print(f"peaks used for bounds: {peaks['float32'] / 1e12:.0f} TFLOP/s "
          f"f32 (CUDA cores), {peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16 "
          f"(tensor cores), {peaks['bytes'] / 1e12:.2f} TB/s")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _native.load_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({_native.stats['built']} of {len(_native.SOURCES)} libraries "
          f"built, the rest found in {_native.build_dir()})")
    for src, log in _native.build_logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                log))
        if regs:
            print(f"  ptxas {src}: {len(regs)} kernels, {min(regs)}-"
                  f"{max(regs)} registers, {spills} bytes of spill stores")
        for line in [l for l in log.splitlines()
                     if "warning" in l.lower()][:8]:
            print(f"  nvcc {src}: {line.strip()[:200]}")

    # -- 3. kernels against their plain versions ------------------------------
    stream = torch.cuda.Stream(dev)
    rng = np.random.default_rng(0)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)) * scale).to(
                dev, dtype)

    def time_ms(fn, iters=20):
        with torch.cuda.stream(stream):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                fn()
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=20, library=False):
        """Device time of one call of ``fn``: ``iters`` calls captured in
        one CUDA graph, replayed and timed with CUDA events, so the host's
        cost of a wrapper call drops out. A port's wrapper that cannot be
        captured fails the run (decode is to run as CUDA graphs); a
        ``library`` call that cannot gives None."""
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                for _ in range(iters):
                    fn()
            with torch.cuda.stream(stream):
                g.replay()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                for _ in range(3):
                    g.replay()
                end.record(stream)
            end.synchronize()
            del g
            return start.elapsed_time(end) / (3 * iters)
        except Exception as e:
            if not library:
                fail(f"a kernel wrapper cannot be captured in a CUDA graph "
                     f"({type(e).__name__}: {e})")
            print(f"  (library call: no graph capture: "
                  f"{type(e).__name__}: {e})")
            torch.cuda.synchronize()
            return None

    def bound(flops, nbytes, dtype="float32"):
        t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def nan_block(like):
        """Hand the caching allocator back a NaN-filled block of ``like``'s
        (shape, dtype) on the check stream, which the kernel's next output
        of that size takes: an output element the kernel skips stays NaN
        rather than the last call's value. Returns its address."""
        if like is None:
            return None
        t = torch.full(like[0], float("nan"), dtype=like[1], device=dev)
        ptr = t.data_ptr()
        del t
        return ptr

    def library_or_error(name, fn):
        """``fn`` where one call of it runs on the card; otherwise None,
        the refusal printed in place of the library's time."""
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except Exception as e:
            torch.cuda.synchronize()
            print(f"  ({name} refused: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]})")
            return None

    def check(label, kernel, plain, library, flops, nbytes,
              dtype="float32", peak=None, exact=False, repeat_equal=False,
              nan_out=None, nan_scratch=None):
        """A kernel returning a tuple is held to its plain version output
        by output, each to its own max|plain|: the worst is reported. With
        ``repeat_equal`` a second launch on the same inputs must give the
        same bits. ``nan_out`` (shape, dtype): each launch's output is
        first filled with NaN where the allocator hands it that block;
        ``nan_scratch`` (floats): so is a K split's f32 scratch."""
        torch.cuda.synchronize()  # inputs were copied on the default stream
        scratch = (((nan_scratch,), torch.float32) if nan_scratch
                   else None)
        with torch.cuda.stream(stream):
            nan_block(scratch)
            nan_ptr = nan_block(nan_out)
            got = kernel()
            hits = int(nan_ptr is not None and got.data_ptr() == nan_ptr)
            ref = plain()
            if repeat_equal:
                nan_block(scratch)
                nan_ptr = nan_block(nan_out)
                again = kernel()
                hits += int(nan_ptr is not None and
                            again.data_ptr() == nan_ptr)
        stream.synchronize()
        if nan_out is not None:
            print(f"  ({hits} of {1 + int(repeat_equal)} launches wrote "
                  f"into a NaN-filled block"
                  + (", each after a NaN-filled scratch block of "
                     f"{nan_scratch} floats" if scratch else "") + ")")
        if repeat_equal and not all(
                torch.equal(a, b) for a, b in
                (zip(got, again) if isinstance(got, tuple)
                 else [(got, again)])):
            fail(f"{label}: two launches on the same inputs differ")
        outs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err, scale, finite = 0.0, 1e-30, True
        for g, r in outs:
            g, r = g.to(torch.float32), r.to(torch.float32)
            e, sc = (g - r).abs().max().item(), max(r.abs().max().item(), 1e-30)
            if e / sc >= err / scale:
                err, scale = e, sc
            finite = finite and bool(torch.isfinite(g).all())
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes, peak or dtype)
        # the redesigned kernels: device time too (the wrapper's host cost
        # bounds ms from below at small shapes)
        dev = {}
        if repeat_equal:
            dev["device_ms"] = device_ms(kernel)
            dev["library_device_ms"] = (device_ms(library, library=True)
                                        if library is not None else None)

        def fmt(v):
            return "-" if v is None else f"{v:.4f}"

        print(f"  {label}: max|d|={err:.3e} rel={err / scale:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{fmt(lib_ms)} bound_ms={b_ms:.6f} ({b_by}, {peak or dtype} "
              f"peak)" + (f"; device_ms={fmt(dev['device_ms'])} "
                          f"library_device_ms="
                          f"{fmt(dev['library_device_ms'])}; two launches "
                          f"bitwise equal" if repeat_equal else ""))
        tol = 0.0 if exact else KERNEL_TOL[dtype]
        if not finite or err / scale > tol:
            fail(f"{label}: kernel disagrees with its plain version "
                 f"(rel {err / scale:.3e} > {tol})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                **dev}

    print("kernels vs plain versions (resnet50@224 shapes):")
    results = {}
    # resnet50's four Winograd stages along plan_f32_gemm(..., batch=16)'s
    # paths (stream: stem, stage0; tile: stage1, stage2), then ragged edges:
    # two column tiles of the stream path (its U slab swapped between
    # items), a ragged tile path
    wino_shapes = [("stem", 12544, 3, 64), ("stage0", 12544, 64, 64),
                   ("stage1", 3136, 128, 128), ("stage2", 784, 256, 256),
                   ("ragged_stream", 300, 5, 70),
                   ("ragged_tile", 257, 100, 33)]
    for tag, T, C, O in wino_shapes:
        V, U = rand(16, T, C), rand(16, C, O)
        plan = plan_f32_gemm(T, O, C, False, 16)
        r = check(f"winograd_tile_matmul {tag} (16,{T},{C})x(16,{C},{O}), "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks)",
                  lambda: ops.winograd_tile_matmul(V, U),
                  lambda: winograd_tile_matmul_plain(V, U),
                  lambda: torch.bmm(V, U),
                  2 * 16 * T * C * O, 4 * 16 * (T * C + C * O + T * O),
                  repeat_equal=True)
        results.setdefault("winograd_tile_matmul", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}
    # the f32 matmul along plan_f32_gemm's paths: resnet50's im2col GEMMs
    # and head, granite-moe-3b-a800m's f32 router (decode at 1 and 4
    # tokens, a 512-token prefill), mamba2-2.7b's f32 decode projections
    # and its tied head reading embed (V, d) K-major in place (decode and a
    # 1024-token prefill), ragged and unaligned edges. (tag, M, K, N,
    # K-major w, x offset in floats: 1 puts x off its 16-byte boundary)
    mm_rows = [("im2col_s1b0", 12544, 576, 128, False, 0),
               ("im2col_s2b0", 3136, 1152, 256, False, 0),
               ("head", 1, 256, 100, False, 0),
               ("granite_router_M1", 1, 1536, 40, False, 0),
               ("granite_router_M4", 4, 1536, 40, False, 0),
               ("granite_router_prefill", 512, 1536, 40, False, 0),
               ("mamba2_in_M1", 1, 2560, 5120, False, 0),
               ("mamba2_bc_M1", 1, 2560, 128, False, 0),
               ("mamba2_dt_M1", 1, 2560, 80, False, 0),
               ("mamba2_out_M1", 1, 5120, 2560, False, 0),
               ("mamba2_head_tied_M1", 1, 2560, 50280, True, 0),
               ("mamba2_head_tied_prefill", 1024, 2560, 50280, True, 0),
               ("mamba2_in_prefill", 1024, 2560, 5120, False, 0),
               ("ragged_skinny", 3, 129, 7, False, 0),
               ("ragged_tile", 100, 200, 4099, False, 0),
               ("ragged_kmajor_tile", 20, 37, 50, True, 0),
               ("ragged_kmajor_skinny", 5, 37, 50, True, 0),
               ("unaligned_x_skinny", 4, 1536, 40, False, 1),
               ("unaligned_x_tile", 64, 576, 128, False, 1),
               # the yardstick of matmul_packed's and matmul_dequant_int4's
               # rows of this shape
               ("up_f32", 64, 960, 2560, False, 0)]
    for tag, M, K, N, kmajor, shift in mm_rows:
        x = rand(M * K + shift)[shift:].view(M, K)
        w = rand(N, K).T if kmajor else rand(K, N)
        plan = plan_f32_gemm(M, N, K, kmajor)
        r = check(f"matmul {tag} ({M},{K})x({K},{N}) "
                  f"{'K-major' if kmajor else 'row-major'} w"
                  f"{', x off 16 B' if shift else ''}, {plan.path} path "
                  f"{plan.bm}x{plan.bn} split {plan.split} ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 4 * (M * K + K * N + M * N),
                  repeat_equal=True)
        results.setdefault("matmul", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}
    # matmul_packed on the f32 path template along plan_f32_gemm(M, N, K):
    # resnet50's packed head (the main path's shape), a tblock up
    # projection in f32 and bf16 x beside the f32 matmul's row of the same
    # shape above, and ragged K and N (two panels, the second cut at 22
    # columns) on both paths; operations at the f32 peak (the weights are
    # f32, whatever x is). (tag, M, K, N, x dtype)
    for tag, M, K, N, dt in [("head", 1, 256, 100, torch.float32),
                             ("up_f32", 64, 960, 2560, torch.float32),
                             ("up_bf16", 64, 960, 2560, torch.bfloat16),
                             ("ragged_tile", 64, 300, 150, torch.float32),
                             ("ragged_skinny", 3, 300, 150, torch.bfloat16)]:
        nK, nN = -(-K // 128), -(-N // 128)
        x = rand(M, K, dtype=dt)
        wfull = rand(K, N, scale=K ** -0.5)
        wpad = torch.zeros(nK * 128, nN * 128, device=dev)
        wpad[:K, :N] = wfull
        wp = wpad.view(nK, 128, nN, 128).permute(2, 0, 1, 3).contiguous()
        plan = plan_f32_gemm(M, N, K)
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        # library: one call of the same function, on the unpacked weight
        # where x is f32 (the packed head's K fills its panels: an einsum)
        lib = (None if dt != torch.float32
               else (lambda: torch.einsum("mkc,nkcd->mnd",
                                          x.view(M, nK, 128), wp)[:, 0])
               if K == nK * 128 and nN == 1 else (lambda: x @ wfull))
        r = check(f"matmul_packed {tag} ({M},{K})x({nN},{nK},128,128) "
                  f"{dname}, {plan.path} path {plan.bm}x{plan.bn} split "
                  f"{plan.split} ({plan.blocks} blocks)",
                  lambda: ops.matmul_packed(x, wp, K, N),
                  lambda: matmul_packed_plain(x, wp, K, N), lib,
                  # the kernel masks the zero rows and columns of each
                  # panel, so it reads the K*N real weights and no padding
                  2 * M * N * K, es * (M * K + M * N) + 4 * K * N, dname,
                  peak="float32", repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_packed", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}

    print("kernels vs plain versions (smollm-360m prefill shapes, bf16):")
    # the seven projections of a block (M = 64 prompt tokens) and the head
    for tag, M, K, N in [("d_model", 64, 960, 960), ("up", 64, 960, 2560),
                         ("down", 64, 2560, 960), ("head", 64, 960, 49152)]:
        x = rand(M, K, dtype=torch.bfloat16)
        w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        r = check(f"matmul_bf16 {tag} ({M},{K})x({K},{N})",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 2 * (M * K + K * N + M * N), "bfloat16",
                  repeat_equal=True)
        results.setdefault("matmul_bf16", {})[tag] = r

    print("kernels vs plain versions (bf16 matmul on the tensor cores: the "
          "decode projections at M 1 and 4 of smollm-360m, granite-moe-3b-"
          "a800m and mamba2-2.7b, mamba2's prefill projection, the tied "
          "heads reading embed (V, d) K-major in place, ragged and "
          "unaligned edges):")
    # (tag, M, K, N, K-major w: a (N, K) tensor passed as its .T)
    mm_rows = [("smollm_head_tied_M64", 64, 960, 49152, True)]
    for M in (1, 4):
        mm_rows += [(f"smollm_d_model_M{M}", M, 960, 960, False),
                    (f"smollm_up_M{M}", M, 960, 2560, False),
                    (f"smollm_down_M{M}", M, 2560, 960, False),
                    (f"smollm_head_tied_M{M}", M, 960, 49152, True),
                    (f"granite_q_o_M{M}", M, 1536, 1536, False),
                    (f"granite_kv_M{M}", M, 1536, 512, False),
                    (f"granite_head_tied_M{M}", M, 1536, 49155, True)]
    # the prefill projections and tied heads of granite (512 tokens) and
    # mamba2 (1024): the only 128-row tiles reading a K-major w
    mm_rows += [("granite_q_o_prefill", 512, 1536, 1536, False),
                ("granite_kv_prefill", 512, 1536, 512, False),
                ("granite_head_tied_prefill", 512, 1536, 49155, True),
                ("mamba2_in_prefill", 1024, 2560, 5120, False),
                ("mamba2_bc_prefill", 1024, 2560, 128, False),
                ("mamba2_dt_prefill", 1024, 2560, 80, False),
                ("mamba2_out_prefill", 1024, 5120, 2560, False),
                ("mamba2_head_tied_prefill", 1024, 2560, 50280, True),
                ("mamba2_in_M4", 4, 2560, 5120, False),
                ("mamba2_out_M4", 4, 5120, 2560, False),
                ("mamba2_head_tied_M4", 4, 2560, 50280, True),
                # scalar copies: K, N or both not a multiple of 8
                ("ragged_skinny", 3, 129, 7, False),
                ("ragged_tile", 100, 200, 49155, False),
                ("ragged_kmajor", 20, 37, 50, True),
                ("unaligned_n_skinny", 5, 1536, 49155, False)]
    for tag, M, K, N, kmajor in mm_rows:
        x = rand(M, K, dtype=torch.bfloat16)
        w = (rand(N, K, dtype=torch.bfloat16, scale=K ** -0.5).T if kmajor
             else rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5))
        plan = plan_bf16_gemm(M, N, K)
        r = check(f"matmul_bf16 {tag} ({M},{K})x({K},{N}) "
                  f"{'K-major' if kmajor else 'row-major'} w, {plan.path} "
                  f"path bm {plan.bm} split {plan.split} ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 2 * (M * K + K * N + M * N), "bfloat16",
                  repeat_equal=True)
        results["matmul_bf16"][tag] = {**r, "path": plan.path,
                                       "split": plan.split}

    def visible_pairs(S, window):
        rows = np.arange(S)
        return int(np.minimum(rows + 1, window or S).sum())

    # (tag, B, S, H, KV, D, window, softcap, dtype); causal throughout.
    # smollm-360m's cold prefill and a long one, granite-moe-3b-a800m's
    # 512-token prefill, zamba2-2.7b's head dim 80 in both dtypes, ragged
    # S, the head dims off the 16-byte grid (67: element loads), 100 and
    # 256, and a plan with two query heads a block
    for tag, B, S, H, KV, D, win, cap, dt in [
            ("prefill64", 1, 64, 15, 5, 64, None, None, torch.bfloat16),
            ("prefill2048", 1, 2048, 15, 5, 64, None, None, torch.bfloat16),
            ("granite512", 1, 512, 24, 8, 64, None, None, torch.bfloat16),
            ("zamba2_d80", 1, 1024, 32, 32, 80, None, None, torch.bfloat16),
            ("zamba2_d80_f32", 1, 1024, 32, 32, 80, None, None,
             torch.float32),
            ("ragged100", 1, 100, 15, 5, 64, None, None, torch.bfloat16),
            ("f32_window_softcap", 1, 1024, 15, 5, 64, 256, 50.0,
             torch.float32),
            ("d32_window", 2, 200, 8, 2, 32, 64, None, torch.bfloat16),
            ("d128_softcap", 2, 130, 4, 4, 128, None, 30.0, torch.bfloat16),
            ("d100_window_softcap", 1, 300, 8, 2, 100, 128, 30.0,
             torch.bfloat16),
            ("d67_window", 1, 200, 4, 2, 67, 64, None, torch.bfloat16),
            ("d256", 1, 256, 4, 4, 256, None, None, torch.bfloat16),
            # a batch with 8 query heads a kv head: two heads a block
            ("batched_gqa", 8, 256, 32, 4, 128, None, None,
             torch.bfloat16)]:
        q = rand(B, S, H, D, dtype=dt, scale=0.5)
        k = rand(B, S, KV, D, dtype=dt, scale=0.5)
        v = rand(B, S, KV, D, dtype=dt, scale=0.5)
        kw = dict(causal=True, window=win, softcap=cap)
        lib = None
        if cap is None and win is None:
            lib = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True))
        dname = str(dt).replace("torch.", "")
        plan = plan_flash(B, S, H, KV, D, dt, True, win)
        r = check(f"flash_attention {tag} B={B} S={S} H={H} KV={KV} D={D} "
                  f"window={win} softcap={cap} {dname}, bq {plan.bq} heads "
                  f"{plan.heads} ksplit {plan.ksplit} bk {plan.bk} dp "
                  f"{plan.dp} ({plan.blocks} blocks of {plan.threads} "
                  f"threads)",
                  lambda: ops.flash_attention(q, k, v, **kw),
                  lambda: flash_attention_plain(q, k, v, **kw), lib,
                  4 * B * H * D * visible_pairs(S, win),
                  q.element_size() * 2 * B * S * (H + KV) * D, dname,
                  repeat_equal=True)
        results.setdefault("flash_attention", {})[tag] = {
            **r, "plan": plan._asdict()}

    print("kernels vs plain versions (decode_attention: the Pallas sweep in "
          "its prefix form, smollm-360m decode shapes, a wrapped ring with a "
          "window, the int8 cache, a softcap):")

    def decode_case(tag, B, W, H, KV, D, dt, pos, window=None, softcap=None,
                    int8=False):
        """Hold decode_attention against its plain version; bound by the
        bytes of the visible cache entries (the kernel reads no other),
        q, the output and pos; SDPA with the same mask where it computes
        the same function (no softcap, no int8 cache)."""
        q = rand(B, H, D, dtype=dt, scale=0.5)
        es = q.element_size()
        if int8:
            k, v = (torch.from_numpy(rng.integers(
                -127, 128, (B, W, KV, D)).astype(np.int8)).to(dev)
                for _ in range(2))
            ks, vs = (torch.from_numpy((rng.random((B, W, KV)) * 0.02
                                        + 1e-3).astype(np.float32)).to(dev)
                      for _ in range(2))
            entry_b = KV * (2 * D + 2 * 4)
        else:
            k, v = rand(B, W, KV, D, dtype=dt), rand(B, W, KV, D, dtype=dt)
            ks = vs = None
            entry_b = 2 * KV * D * es
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        mask = attn_visible(p, W, window)
        n_vis = int(mask.sum().item())
        kw = dict(window=window, softcap=softcap, k_scale=ks, v_scale=vs)
        lib = None
        if not int8 and softcap is None:
            qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
            m4 = mask[:, None, None, :]
            lib = (lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=m4, enable_gqa=True))
        dname = str(dt).replace("torch.", "")
        plan = plan_decode(B, W, H, KV, D)
        r = check(f"decode_attention {tag} B={B} W={W} H={H} KV={KV} D={D} "
                  f"window={window} softcap={softcap} "
                  f"{'int8 cache' if int8 else dname} visible={n_vis}; "
                  f"split {plan.split} of {plan.chunk} entries, {plan.hg} "
                  f"heads a block, {plan.lpr} lanes a row ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.decode_attention(q, k, v, p, **kw),
                  lambda: decode_attention_plain(q, k, v, p, **kw), lib,
                  4 * H * D * n_vis,
                  n_vis * entry_b + 2 * B * H * D * es + 4 * B, dname,
                  repeat_equal=True)
        results.setdefault("decode_attention", {})[tag] = {
            **r, "split": plan.split, "chunk": plan.chunk}

    # the Pallas sweep (tests/test_kernels.py), prefix lengths as positions
    for S, H, KV, D in [(512, 8, 4, 64), (300, 4, 4, 32), (256, 8, 2, 128)]:
        lens = rng.integers(1, S + 1, size=3)
        decode_case(f"sweep_S{S}_D{D}", 3, S, H, KV, D, torch.float32,
                    [int(n) - 1 for n in lens])
    # smollm-360m: 15 heads, 5 kv heads, D 64; a full cache (pos = W - 1);
    # W 82 is the cold-start decode's max_len, 512 the batched server's
    for B in (1, 4):
        for W in (82, 512, 4096):
            for dt in (torch.bfloat16, torch.float32):
                decode_case(f"B{B}_W{W}_{str(dt)[6:]}", B, W, 15, 5, 64, dt,
                            [W - 1] * B)
    decode_case("ring_window32_W32", 2, 32, 15, 5, 64, torch.bfloat16,
                [47, 40], window=32)
    decode_case("ring_window1024_W4096", 4, 4096, 15, 5, 64, torch.bfloat16,
                [5000, 4200, 9000, 4095], window=1024)
    decode_case("int8_B4_W512", 4, 512, 15, 5, 64, torch.bfloat16,
                [511] * 4, int8=True)
    decode_case("int8_ring_B4_W4096", 4, 4096, 15, 5, 64, torch.bfloat16,
                [6000, 4095, 5000, 7000], window=2048, int8=True)
    decode_case("softcap_d128", 2, 1024, 32, 16, 128, torch.bfloat16,
                [1023, 700], window=512, softcap=50.0)
    # granite-moe-3b-a800m (24 heads, 8 kv heads, D 64)
    for B, W in ((1, 512), (4, 4096)):
        decode_case(f"granite_B{B}_W{W}", B, W, 24, 8, 64, torch.bfloat16,
                    [W - 1] * B)
    # zamba2-2.7b's shared attention (32 heads, 32 kv heads, D 80)
    decode_case("zamba2_d80_B1_W4096", 1, 4096, 32, 32, 80, torch.bfloat16,
                [4095])
    decode_case("zamba2_d80_ring_B4_W512", 4, 512, 32, 32, 80,
                torch.bfloat16, [700, 511, 100, 1500], window=256)
    decode_case("d80_int8_B2_W512", 2, 512, 32, 32, 80, torch.bfloat16,
                [511, 300], int8=True)
    # head dims that are not a multiple of 8: 100 in f32 (16-byte rows, a
    # lane with half a chunk), 67 in bf16 (134-byte rows: element loads)
    decode_case("d100_f32", 2, 600, 8, 2, 100, torch.float32, [599, 250])
    decode_case("d67_bf16_softcap", 2, 600, 6, 3, 67, torch.bfloat16,
                [599, 1000], window=300, softcap=30.0)
    decode_case("d256_bf16", 1, 1024, 8, 1, 256, torch.bfloat16, [1023])

    print("kernels vs plain versions (quantized cache: smollm-360m block "
          "and head, resnet50 head):")
    # a tblock's seven projections and the LM head, then ragged shapes
    # (odd K for int4); exact: one f32 multiply of exact values
    for tag, K, N in [("d_model", 960, 960), ("kv", 960, 320),
                      ("up", 960, 2560), ("down", 2560, 960),
                      ("head", 960, 49152), ("ragged37x16", 37, 16),
                      ("ragged129x7", 129, 7)]:
        a = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        q8, s8, _ = quant.quantize_int8(a)
        p4, s4 = quant.quantize_int4(a)
        tq8, ts8, tp4, ts4 = (torch.from_numpy(v).to(dev)
                              for v in (q8, s8, p4, s4))
        r = check(f"dequant_int8 {tag} ({K},{N})",
                  lambda: ops.dequant_int8(tq8, ts8),
                  lambda: Q.dequant_int8_plain(tq8, ts8),
                  lambda: torch.mul(tq8, ts8),
                  K * N, K * N + 4 * N + 4 * K * N, exact=True)
        results.setdefault("dequant_int8", {})[tag] = r
        r = check(f"dequant_int4 {tag} ({K},{N})",
                  lambda: ops.dequant_int4(tp4, ts4, K),
                  lambda: Q.dequant_int4_plain(tp4, ts4, K), None,
                  K * N, (K + 1) // 2 * N + 4 * N + 4 * K * N, exact=True)
        results.setdefault("dequant_int4", {})[tag] = r
    # the fused kernels: resnet50's head (the main path's shape), a tblock
    # up projection in f32 and bf16, a ragged case; for the loaders, a
    # decode projection at M 1 (16-byte loads) and M 8 (4-byte), and
    # ragged tiles with an odd K (4-byte and 1-byte copies); operations at
    # the peak of x's type (int8 and int4 weights are exact in bf16, so
    # bf16 x could run at the bf16 tensor-core rate). The int8 rows' library
    # call: torch._weight_int8pack_mm(x, q^T, s), (x · q) · s in one call,
    # with q^T made outside the timed window; where the card refuses it,
    # the row prints the error in place of a time
    for tag, M, K, N, dt in [
            ("resnet_head", 1, 256, 100, torch.float32),
            ("up_f32", 64, 960, 2560, torch.float32),
            ("up_bf16", 64, 960, 2560, torch.bfloat16),
            ("ragged", 3, 129, 7, torch.float32),
            ("up_M1", 1, 960, 2560, torch.float32),
            ("up_M8", 8, 960, 2560, torch.bfloat16),
            ("ragged_tile", 64, 129, 100, torch.bfloat16),
            ("ragged_tile_bytes", 20, 37, 7, torch.float32)]:
        x = rand(M, K, dtype=dt)
        a = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        q8, s8, _ = quant.quantize_int8(a)
        p4, s4 = quant.quantize_int4(a)
        tq8, ts8, tp4, ts4 = (torch.from_numpy(v).to(dev)
                              for v in (q8, s8, p4, s4))
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        io = es * M * K + 4 * N + es * M * N
        plan = plan_f32_gemm(M, N, K)
        qT, sv = tq8.T.contiguous(), ts8.view(-1)
        lib8 = library_or_error(
            "torch._weight_int8pack_mm",
            lambda: torch._weight_int8pack_mm(x, qT, sv))
        loader = Q.q_loader(tq8, M, plan.path)
        r = check(f"matmul_dequant_int8 {tag} ({M},{K})x({K},{N}) {dname}, "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks), {loader}-byte loader",
                  lambda: ops.matmul_dequant_int8(x, tq8, ts8),
                  lambda: Q.matmul_dequant_int8_plain(x, tq8, ts8), lib8,
                  2 * M * N * K, io + K * N, dname,
                  repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_dequant_int8", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split, "loader_bytes": loader}
        loader = Q.q_loader(tp4, M, plan.path)
        r = check(f"matmul_dequant_int4 {tag} ({M},{K})x({K},{N}) {dname}, "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks), {loader}-byte loader",
                  lambda: ops.matmul_dequant_int4(x, tp4, ts4, K),
                  lambda: Q.matmul_dequant_int4_plain(x, tp4, ts4, K), None,
                  2 * M * N * K, io + (K + 1) // 2 * N, dname,
                  repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_dequant_int4", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split, "loader_bytes": loader}
    # the bf16 matmul's f32-out entry at LinearLowPrecision's resnet50 head;
    # the products of bf16 values are exact in f32, so the f32 tolerance
    M, K, N = 1, 256, 100
    x = rand(M, K, dtype=torch.bfloat16)
    w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
    r = check(f"matmul_bf16 f32-out resnet_head ({M},{K})x({K},{N})",
              lambda: ops.matmul(x, w, out_dtype=torch.float32),
              lambda: matmul_plain(x, w, torch.float32), None,
              2 * M * N * K, 2 * (M * K + K * N) + 4 * M * N, "float32",
              peak="bfloat16")
    results["matmul_bf16"]["resnet_head_f32out"] = r
    # and at mamba2's prefill projection, the one bound by operations
    M, K, N = 1024, 2560, 5120
    x = rand(M, K, dtype=torch.bfloat16)
    w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
    r = check(f"matmul_bf16 f32-out mamba2_in_prefill ({M},{K})x({K},{N})",
              lambda: ops.matmul(x, w, out_dtype=torch.float32),
              lambda: matmul_plain(x, w, torch.float32), None,
              2 * M * N * K, 2 * (M * K + K * N) + 4 * M * N, "float32",
              peak="bfloat16", repeat_equal=True)
    results["matmul_bf16"]["mamba2_in_prefill_f32out"] = r

    print("kernels vs plain versions (gmm_blocks: granite-moe-3b-a800m's "
          "expert GEMMs at decode and at a 512-token prefill, bf16; the "
          "Pallas sweep in f32 and bf16):")
    # (tag, E, C, d, n, dtype); C = 8 at decode (4 slots x top-8 of 40
    # experts), 208 at a 512-token prefill (capacity factor 2)
    for tag, E, C, d, n, dt in [
            ("decode_gate", 40, 8, 1536, 512, torch.bfloat16),
            ("decode_down", 40, 8, 512, 1536, torch.bfloat16),
            ("prefill_gate", 40, 208, 1536, 512, torch.bfloat16),
            ("sweep_4x64x32x48_f32", 4, 64, 32, 48, torch.float32),
            ("sweep_8x128x128x128_f32", 8, 128, 128, 128, torch.float32),
            ("sweep_3x40x20x9_f32", 3, 40, 20, 9, torch.float32),
            ("sweep_4x64x32x48_bf16", 4, 64, 32, 48, torch.bfloat16),
            ("sweep_8x128x128x128_bf16", 8, 128, 128, 128, torch.bfloat16),
            ("sweep_3x40x20x9_bf16", 3, 40, 20, 9, torch.bfloat16)]:
        x = rand(E, C, d, dtype=dt)
        w = rand(E, d, n, dtype=dt, scale=d ** -0.5)
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) {dname}",
                  lambda: ops.gmm_blocks(x, w), lambda: gmm_blocks_plain(x, w),
                  lambda: torch.bmm(x, w), 2 * E * C * d * n,
                  es * (E * C * d + E * d * n + E * C * n), dname,
                  repeat_equal=True)
        results.setdefault("gmm_blocks", {})[tag] = r
    # with group sizes: decode's top-8-of-40 routing of 1 and of 4 tokens
    # (C 8), a 512-token prefill's counts clipped at C 208 with two idle
    # experts, and the f32 entry with an empty, a partial and a full
    # expert. The bound counts what these sizes need: the rows that hold
    # tokens, the weights of the experts that have any, the whole output;
    # no single PyTorch call computes this function, so no library time
    E, d, n = 40, 1536, 512
    routed_cases = []
    for T in (1, 4):
        picks = np.concatenate([rng.choice(E, 8, replace=False)
                                for _ in range(T)])
        routed_cases.append((f"decode_gate_routed_T{T}", 8,
                             np.bincount(picks, minlength=E), torch.bfloat16))
    counts = np.minimum(rng.multinomial(512 * 8, np.ones(E) / E), 208)
    counts[[3, 17]] = 0
    routed_cases.append(("prefill_gate_routed", 208, counts, torch.bfloat16))
    for tag, C, gs_np, dt in routed_cases:
        x = rand(E, C, d, dtype=dt)
        w = rand(E, d, n, dtype=dt, scale=d ** -0.5)
        gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
        rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) bfloat16, "
                  f"{rows} rows in {active} experts",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * rows * d * n, 2 * (rows * d + active * d * n + E * C * n),
                  "bfloat16", repeat_equal=True)
        results["gmm_blocks"][tag] = {**r, "experts_read": active}
    for dt in (torch.float32, torch.bfloat16):
        E3, C3, d3, n3 = 3, 40, 20, 9
        x, w = rand(E3, C3, d3, dtype=dt), rand(E3, d3, n3, dtype=dt)
        gs = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
        dname = str(dt).replace("torch.", "")
        split = (plan_f32_gemm(C3, n3, d3, False, E3, True).split
                 if dt == torch.float32 else plan_bf16_gemm(C3, n3, d3,
                                                            E3).split)
        r = check(f"gmm_blocks sweep_3x40x20x9_group_sizes_0_17_40 {dname}, "
                  f"split {split}",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * 57 * d3 * n3,
                  x.element_size() * (57 * d3 + 2 * d3 * n3 + E3 * C3 * n3),
                  dname, repeat_equal=True, nan_out=((E3, C3, n3), dt),
                  nan_scratch=split * E3 * C3 * n3 if split > 1 else None)
        results["gmm_blocks"][f"sweep_group_sizes_{dname}"] = r
    # the f32 entry at granite-moe-3b-a800m's widths, along plan_f32_gemm(
    # C, n, d, batch=E, row_limit=True): the batched skinny path at
    # decode (C 8) and the batched tile path at a 512-token prefill (C 208),
    # without group sizes (torch.bmm beside them) and routed as above (the
    # bound counts what the sizes need; no library call computes it)
    f32_cases = [("decode_gate_f32", 8, None),
                 ("decode_gate_routed_T1_f32", 8, routed_cases[0][2]),
                 ("decode_gate_routed_T4_f32", 8, routed_cases[1][2]),
                 ("prefill_gate_f32", 208, None),
                 ("prefill_gate_routed_f32", 208, routed_cases[2][2])]
    for tag, C, gs_np in f32_cases:
        x = rand(E, C, d)
        w = rand(E, d, n, scale=d ** -0.5)
        plan = plan_f32_gemm(C, n, d, False, E, True)
        desc = (f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                f"({plan.blocks} blocks)")
        scratch = plan.split * E * C * n if plan.split > 1 else None
        if gs_np is None:
            r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) "
                      f"float32, {desc}",
                      lambda: ops.gmm_blocks(x, w),
                      lambda: gmm_blocks_plain(x, w),
                      lambda: torch.bmm(x, w), 2 * E * C * d * n,
                      4 * (E * C * d + E * d * n + E * C * n),
                      repeat_equal=True, nan_out=((E, C, n), torch.float32),
                      nan_scratch=scratch)
            results["gmm_blocks"][tag] = {**r, "path": plan.path}
            continue
        gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
        rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) float32, "
                  f"{rows} rows in {active} experts, {desc}",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * rows * d * n,
                  4 * (rows * d + active * d * n + E * C * n),
                  repeat_equal=True, nan_out=((E, C, n), torch.float32),
                  nan_scratch=scratch)
        results["gmm_blocks"][tag] = {**r, "path": plan.path,
                                      "experts_read": active}

    print("kernels vs plain versions (ssd_scan: mamba2-2.7b at S 1024 in "
          "bf16 from a zero and a random state, in f32, at B 4, and at S 512 "
          "from a random state; zamba2-2.7b's N 64; y and the final state; "
          "a ragged shape; the Pallas sweep):")
    # (tag, B, S, H, P, N, Q, dtype, init state)
    ssd_rows = [
        ("mamba2_S1024", 1, 1024, 80, 64, 128, 256, torch.bfloat16, False),
        ("mamba2_S1024_init", 1, 1024, 80, 64, 128, 256, torch.bfloat16,
         True),
        ("mamba2_S1024_f32", 1, 1024, 80, 64, 128, 256, torch.float32,
         False),
        ("zamba2_S1024_N64", 1, 1024, 80, 64, 64, 256, torch.bfloat16, False),
        ("mamba2_B4_S1024", 4, 1024, 80, 64, 128, 256, torch.bfloat16, False),
        ("mamba2_S512_init", 1, 512, 80, 64, 128, 256, torch.bfloat16, True),
        ("ragged_P60_N100_Q96", 2, 192, 3, 60, 100, 96, torch.float32, True),
        ("ragged_P60_N100_Q96_bf16", 2, 192, 3, 60, 100, 96, torch.bfloat16,
         True),
        ("sweep_S256_N32", 2, 256, 4, 64, 32, 64, torch.float32, False),
        ("sweep_S128_N16", 2, 128, 2, 32, 16, 32, torch.float32, False),
        ("sweep_S192_N64", 2, 192, 4, 64, 64, 64, torch.float32, True)]
    for tag, B, S, H, P, N, Q, dt, init in ssd_rows:
        x = rand(B, S, H, P, dtype=dt, scale=0.3)
        sdt = (torch.from_numpy(np.abs(rng.standard_normal(
            (B, S, H))).astype(np.float32)) * 0.3).to(dev)
        A = -torch.linspace(0.5, 2.0, H, device=dev)
        Bm, Cm = rand(B, S, N, dtype=dt, scale=0.3), rand(B, S, N, dtype=dt,
                                                         scale=0.3)
        D = torch.ones(H, device=dev)
        st = rand(B, H, P, N, scale=0.3) if init else None
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        # operations the function needs over each chunk's lower triangle:
        # C·B^T on Q(Q+1)/2 pairs once per (b, chunk), since every head
        # shares B and C (G = 1); per head its product with x on those
        # pairs, C·state and the state update on Q x N x P; bounded at the
        # peak of x's type (bf16: the tensor cores)
        nc, pairs = S // Q, Q * (Q + 1) // 2
        flops = (2 * B * nc * pairs * N
                 + 2 * B * H * nc * (pairs * P + 2 * Q * N * P))
        nbytes = (es * (2 * B * S * H * P + 2 * B * S * N)
                  + 4 * (B * S * H + 2 * H) + 4 * B * H * P * N * (1 + init))
        plan = plan_ssd(B, S, H, P, N, Q, dt)
        r = check(f"ssd_scan {tag} B={B} S={S} H={H} P={P} N={N} Q={Q} "
                  f"{dname} init_state={init}, blocks of the four phases "
                  f"{plan.blocks}",
                  lambda: ops.ssd_scan(x, sdt, A, Bm, Cm, D, chunk=Q,
                                       init_state=st),
                  lambda: ssd_scan_plain(x, sdt, A, Bm, Cm, D, chunk=Q,
                                         init_state=st),
                  None, flops, nbytes, dname, repeat_equal=True)
        results.setdefault("ssd_scan", {})[tag] = {**r,
                                                   "blocks": plan.blocks}
    torch.cuda.synchronize()
    print(f"  [kernel phases done at {time.perf_counter() - t_start:.1f} s]")
    if "--kernels-only" in sys.argv[1:]:
        print("chip_smoke: --kernels-only: stopped after the kernel checks")
        sys.exit(0)
    launches = {}

    # -- 4. the main path ---------------------------------------------------
    layers, x_np = build_cnn("resnet50", image=224, width=1.0, classes=100,
                             seed=0)

    def plain_forward(x_in, head=None):
        """All-plain forward: cuDNN convs (TF32 off) and a plain head,
        ``head(y, layer)`` where given."""
        y = torch.from_numpy(x_in).to(dev)
        direct = ConvDirect()
        for l in layers:
            if l.spec.op_type == "stateless":
                y = l.fn(y)
                continue
            w = {k: torch.from_numpy(v).to(dev) for k, v in l.weights.items()}
            if l.spec.op_type == "conv2d":
                y = direct.execute(w, y, l.spec)
            elif head is not None:
                y = head(y, l)
            else:
                y = matmul_plain(y, w["w"]) + w["b"]
        torch.cuda.synchronize()
        return y

    ref_out = plain_forward(x_np)

    def check_output(label, out, ref=ref_out):
        out = out.detach()
        if tuple(out.shape) != (1, 100) or not torch.isfinite(out).all():
            fail(f"{label}: output shape {tuple(out.shape)} or non-finite")
        rel = ((out - ref).abs().max().item()
               / max(ref.abs().max().item(), 1e-30))
        print(f"  {label}: output (1, 100), max|d|/max|ref| = {rel:.3e}")
        if rel > PATH_TOL:
            fail(f"{label}: output disagrees with the all-plain forward "
                 f"({rel:.3e} > {PATH_TOL})")

    print("main path: resnet50 image=224 width=1.0, store_fmt=super")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         device="cuda")
        t0 = time.perf_counter()
        stats = eng.decide(x_np)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"io_interference={stats['io_interference']:.3f} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        weighted = [l for l in layers if l.spec.weight_shapes]
        choices = {l.spec.name: stats["choices"][l.spec.name]
                   for l in weighted}
        summary = {}
        for kern, cached in choices.values():
            key = f"{kern}/{'cache' if cached else 'raw'}"
            summary[key] = summary.get(key, 0) + 1
        print(f"  plan summary: {json.dumps(summary)}")
        print(f"  plan: {json.dumps(choices)}")

        def pinned(conv_s1, conv_s2, head):
            out = []
            for l in layers:
                if l.spec.op_type == "stateless":
                    out.append(Choice("fn", False))
                elif l.spec.op_type == "linear":
                    out.append(Choice(head, False))
                else:
                    s = l.spec.config.get("stride", 1)
                    out.append(Choice(conv_s1 if s == 1 else conv_s2, False))
            return out

        runs = [("decided plan", None),
                ("pinned winograd+packed",
                 pinned("winograd_f2x3", "im2col_sgemm", "packed")),
                ("pinned im2col+direct",
                 pinned("im2col_sgemm", "im2col_sgemm", "direct"))]
        decided = eng.plan
        per_run = []
        # the Winograd GEMM shapes of each run, for their time a forward
        wino_calls = {}
        wino_kernel = ops.winograd_tile_matmul

        def wino_recording(V, U):
            wino_calls.setdefault(label, []).append(
                (tuple(V.shape), tuple(U.shape)))
            return wino_kernel(V, U)

        ops.winograd_tile_matmul = wino_recording
        ops.reset_launch_counts()
        for label, pin in runs:
            before = ops.launch_counts()
            if pin is not None:
                eng.set_plan(replace(decided, choices=pin))
            start = (decided_arm_state(eng, "nnv12", "")
                     if pin is None else AS_LEFT)
            r = eng.run_cold(x_np)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            per_run.append((label, delta))
            print(f"  run_cold [{label}; start: {start}]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)}")
            check_output(label, r.output)
        ops.winograd_tile_matmul = wino_kernel
        cnn_counts = ops.launch_counts()
        for k in ("matmul", "matmul_packed", "winograd_tile_matmul"):
            launches[k] = cnn_counts[k]
        # the Winograd GEMMs of one pinned-Winograd forward: device time of
        # the kernel and of torch.bmm at each shape (CUDA-graph replay),
        # summed over the forward's calls (after the counted runs)
        calls = wino_calls.get("pinned winograd+packed", [])
        t_k = t_b = 0.0
        for shape in sorted(set(calls)):
            n = calls.count(shape)
            V, U = rand(*shape[0]), rand(*shape[1])
            dk = device_ms(lambda: ops.winograd_tile_matmul(V, U))
            db = device_ms(lambda: torch.bmm(V, U), library=True)
            t_k += n * dk
            t_b += n * (db or 0.0)
            print(f"  Winograd GEMM {shape[0]}x{shape[1]} x{n}: device "
                  f"{dk:.4f} ms, torch.bmm {db if db is None else round(db, 4)}"
                  f" ms")
        print(f"  resnet50 pinned winograd+packed forward: {len(calls)} "
              f"Winograd GEMMs, {t_k:.4f} ms of kernel device time "
              f"(torch.bmm {t_b:.4f} ms)")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the main path: {repairs} "
                 f"{open_breakers}")
        for k, n in launches.items():
            if n <= 0:
                fail(f"kernel {k} never launched on the CNN path")
        # the other entry points of the slice, outside the counted window
        eng.set_plan(decided)
        for label, mode, audit in [("decided plan", "nnv12_nosteal", ""),
                                   *DECIDED_ARMS[1:]]:
            start = decided_arm_state(eng, mode, audit)
            r = eng.run_cold(x_np, mode=mode)
            print(f"  run_cold [{label}, {mode}; start: {start}]: "
                  f"total_s={r.total_s:.4f}")
            check_output(f"{label} {mode}", r.output)
        print(f"  run_warm: {eng.run_warm(x_np):.4f} s")
        # staging through the pinned-slab DMA thread against inline host
        # staging, on the pinned Winograd plan, alternated
        host_stage = StageEngine("host")
        host_eng = ColdEngine(layers, Path(tmp) / "store_host",
                              store_fmt="super", device="cuda",
                              stage_engine=host_stage)
        host_eng.ensure_plan(x_np)
        wino = replace(decided, choices=runs[1][1])
        eng.set_plan(wino)
        host_eng.set_plan(wino)
        for label, e in (("dma", eng), ("host", host_eng),
                         ("dma", eng), ("host", host_eng)):
            r = e.run_cold(x_np)
            print(f"  run_cold [pinned winograd+packed, stage engine {label}]:"
                  f" total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())}")
            check_output(f"stage engine {label}", r.output)
        for e in (eng, host_eng):
            if e.repairs.counts().get("kernel_demoted"):
                fail(f"kernels were demoted: {e.repairs.counts()}")
        host_stage.close()

        # the lossy CNN path: the head on the int8, int4 and bf16 caches
        print("lossy CNN path: resnet50 image=224 width=1.0, allow_lossy=True,"
              " store_fmt=super")
        leng = ColdEngine(layers, Path(tmp) / "store_lossy",
                          store_fmt="super", allow_lossy=True, device="cuda")
        leng.profiler_factory = SyntheticProfiler
        t0 = time.perf_counter()
        stats = leng.decide(x_np, calibrate_interference=False)
        print(f"  decide (SyntheticProfiler): {time.perf_counter() - t0:.2f}"
              f" s, profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        head = next(l for l in layers if l.spec.op_type == "linear")
        print(f"  plan for the head: {json.dumps(stats['choices'][head.spec.name])}")
        for kernel in ("int8", "int4", "bf16"):
            materialize(leng, head, kernel)
        leng.store.maintain()

        def lossy_head(kernel):
            w = layer_weights(leng, head, kernel, True, dev)
            if kernel == "bf16":  # bf16 operands, f32 accumulation
                return lambda y, l: matmul_plain(
                    y.to(torch.bfloat16), w["w"], torch.float32) + w["b"]
            return lambda y, l: matmul_plain(y, w["w"]) + w["b"]

        # the head's kernel for each arm: one launch a run, and none of the
        # other arms' kernels
        head_kernels = {"int8": "matmul_dequant_int8",
                        "int4": "matmul_dequant_int4", "bf16": "matmul_bf16"}
        ops.reset_launch_counts()
        for kernel in ("int8", "int4", "bf16"):
            pin = [Choice(kernel, True) if l.spec.op_type == "linear" else c
                   for l, c in zip(layers, pinned("im2col_sgemm",
                                                  "im2col_sgemm", "direct"))]
            leng.set_plan(replace(leng.plan, choices=pin))
            before = ops.launch_counts()
            r = leng.run_cold(x_np)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            print(f"  run_cold [head {kernel} cached, im2col convs]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)} cache bytes of the head "
                  f"{leng.store.cached_bytes(head.spec.name, kernel)}")
            check_output(f"lossy head {kernel}", r.output,
                         plain_forward(x_np, lossy_head(kernel)))
            for arm, k in head_kernels.items():
                want = 1 if arm == kernel else 0
                if delta.get(k, 0) != want:
                    fail(f"lossy head {kernel}: {k} launched "
                         f"{delta.get(k, 0)} times in the run, expected "
                         f"{want}")
        lossy_counts = ops.launch_counts()
        for k in ("matmul_dequant_int8", "matmul_dequant_int4"):
            launches[k] = lossy_counts[k]
            if lossy_counts[k] <= 0:
                fail(f"kernel {k} never launched on the lossy CNN path")
        if leng.repairs.counts().get("kernel_demoted") \
                or leng.breaker.open_keys():
            fail(f"kernels were demoted: {leng.repairs.counts()}")

        # -- 4a. continuous mode: kernel switching ---------------------------
        for k, n in switching_path(card, eng, layers, x_np, decided,
                                   runs[2][1], check_output).items():
            launches[k] += n
        if eng.repairs.counts().get("kernel_demoted") \
                or eng.breaker.open_keys():
            fail(f"kernels were demoted: {eng.repairs.counts()}")
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    print(f"  [CNN path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 4b. the front-door fleet with peer warm-state transfer --------------
    for k, n in fleet_path(card, x_np, ref_out, check_output).items():
        launches[k] += n
    print(f"  [fleet path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 5. the cold-LLM path -----------------------------------------------
    launches.update(llm_path(dev, LLM_DEPTH))
    print(f"  [LLM path done at {time.perf_counter() - t_start:.1f} s]")
    launches.update(llm_lossy_path(dev, LOSSY_DEPTH))
    print(f"  [lossy LLM path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 6. the serving path -------------------------------------------------
    launches.update(serving_path(dev, SERVE_DEPTH))
    print(f"  [serving path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 7. the moe and ssm families ------------------------------------------
    # the f32 matmul's launches sum the CNN path's, granite's router and
    # mamba2's f32 runs
    for family, path, depth in (("moe", moe_path, MOE_DEPTH),
                                ("ssm", ssm_path, SSM_DEPTH)):
        counts = path(dev, depth)
        launches["matmul"] += counts.pop("matmul")
        launches.update(counts)
        torch.cuda.empty_cache()
        print(f"  [{family} path done at "
              f"{time.perf_counter() - t_start:.1f} s]")

    # -- 8. report ----------------------------------------------------------
    main_shape = {"winograd_tile_matmul": "stage0", "matmul": "im2col_s1b0",
                  "matmul_packed": "head", "matmul_bf16": "head",
                  "flash_attention": "prefill64",
                  "decode_attention": "B1_W82_bfloat16",
                  "dequant_int8": "head",
                  "dequant_int4": "head",
                  "matmul_dequant_int8": "resnet_head",
                  "matmul_dequant_int4": "resnet_head",
                  "gmm_blocks": "decode_gate",
                  "ssd_scan": "mamba2_S1024"}
    out = []
    for k, (source, replaces) in ops.KERNELS.items():
        r = results[k][main_shape[k]]
        out.append({"name": k, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[k],
                    "shape": main_shape[k], **r})
    print(f"kernels: " + ", ".join(f"{k}={n}" for k, n in launches.items()))
    print(card)  # again near the end, where a clipped log still shows it
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
