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
     and one library call with CUDA events; ``decode_attention`` also over
     the Pallas sweep in its prefix form, a wrapped ring with a window, the
     int8 cache and a softcap;
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
     with its token count (agreement with the plain run is reported);
  7. fails unless every kernel of a path launched during that path's runs
     (each path's launch counts are zeroed just before its runs and read
     just after) and no kernel was demoted by the fault ladder.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. With no CUDA device, or without the repository's sources beside
it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
import importlib.metadata
import json
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
LLM_DEPTH = 32
LOSSY_DEPTH = 32
SERVE_DEPTH = 32
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
                                               flash_attention_plain)
    from repro_torch.kernels.matmul import matmul_plain

    plain = {"matmul": matmul_plain, "flash_attention": flash_attention_plain,
             "decode_attention": decode_attention_plain,
             "dequant_int8": Q.dequant_int8_plain,
             "dequant_int4": Q.dequant_int4_plain,
             "matmul_dequant_int8": Q.matmul_dequant_int8_plain,
             "matmul_dequant_int4": Q.matmul_dequant_int4_plain}
    saved = {k: getattr(ops, k) for k in plain}
    for k, fn in plain.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


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
        for label, plan, mode in [
                ("decided plan", None, "nnv12"),
                ("decided plan", None, "sequential"),
                ("pinned f32_direct", pinned("f32_direct", False), "nnv12"),
                ("pinned bf16_cast cached", pinned("bf16_cast", True),
                 "nnv12")]:
            before = ops.launch_counts()
            if plan is not None:
                eng.set_plan(plan)
            r = eng.run_cold(toks, mode=mode)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            print(f"  run_cold [{label}, {mode}]: total_s={r.total_s:.4f} "
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
    failures = []
    launch_gates = []   # (label, kernel, launched, expected or None)

    def gate(ok, msg):
        if not ok:
            failures.append(msg)

    def gpu_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

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
        launch_gates.append(("cold start", "decode_attention",
                             cold_counts["decode_attention"],
                             depth * res.decode_steps))
        for k in ("flash_attention", "matmul_bf16"):
            launch_gates.append(("cold start", k, cold_counts[k], None))
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
        print(f"  MemoryBudget after close: {json.dumps(budget)} "
              f"(KV reservations left: {kv_left} B; resident "
              f"{srv.resident_bytes()} B)")
        gate(kv_left == 0 and budget["used"] == srv.resident_bytes(),
             "the KV reservation did not return to the budget")
        repairs = eng.repairs.counts()
        gate(not repairs.get("kernel_demoted") and not eng.breaker.open_keys(),
             f"kernels were demoted on the serving path: {repairs}")
        del srv, eng, res
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()

    # the tied head copies the embedding (.T.contiguous()) every step
    emb = pdev["embed"]
    print(f"  tied-head embed.T.contiguous() per decode step: "
          f"{gpu_ms(lambda: emb.T.contiguous()):.4f} ms "
          f"({emb.numel() * emb.element_size()} B)")

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
        launch_gates.append((f"teacher-forced {arm}", "decode_attention",
                             launched, depth * S))

    # where a decode step's time goes: device busy time under the profiler
    # (B=1 at the cold start's cache length; reported, not gated)
    try:
        from torch.profiler import ProfilerActivity, profile

        state = T.init_decode_state(cfg, 1, 82, device=dev)
        one = tf_toks[:1]
        for t in range(4):  # warm
            T.decode_step(pdev, state, {"tokens": one[:, t:t + 1]}, t, cfg)
        torch.cuda.synchronize()
        n = 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(4, 4 + n):
                T.decode_step(pdev, state, {"tokens": one[:, t:t + 1]}, t,
                              cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: an aten op's device time is its kernels' again
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kern) / 1e3  # ms
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        top += [e for e in kern if "decode_kernel" in e.key and e not in top]
        print(f"  profiler, {n} decode steps B=1 W=82: wall "
              f"{wall * 1e3 / n:.3f} ms/step, device busy "
              f"{busy / n:.3f} ms/step (idle share "
              f"{1 - busy / (wall * 1e3):.3f}); kernels by device time: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.4f}"
                          f" ms/step in {e.count / n:g} launches"
                          for e in top))
    except Exception as e:  # a breakdown only: report it, never fail on it
        print(f"  profiler: unavailable ({type(e).__name__}: {e})")

    # BatchedServer: 6 greedy requests through 4 slots (recycled)
    rng = np.random.default_rng(2)
    shapes = [(8, 8), (64, 32), (23, 16), (40, 24), (12, 12), (57, 20)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n, _ in shapes]

    def batched(plain):
        srv = BatchedServer(pdev, cfg, max_batch=4, max_len=512, device=dev)
        for i, (p, (_, m)) in enumerate(zip(prompts, shapes)):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        before = ops.launch_counts()["decode_attention"]
        t0 = time.perf_counter()
        with plain_kernels() if plain else contextlib.nullcontext():
            done = srv.run_until_drained()
        dt = time.perf_counter() - t0
        return ({r.rid: r.out_tokens for r in done}, srv.decode_steps, dt,
                ops.launch_counts()["decode_attention"] - before)

    got, steps, dt, launched = batched(False)
    want, _, dt_p, _ = batched(True)
    agree = sum(a == b for i in got for a, b in zip(got[i], want.get(i, [])))
    total = sum(m for _, m in shapes)
    finished = all(len(got.get(i, [])) == m for i, (_, m) in enumerate(shapes))
    print(f"  BatchedServer(max_batch=4, max_len=512): 6 requests, prompts "
          f"{[n for n, _ in shapes]}, max_new_tokens {[m for _, m in shapes]};"
          f" all finished with their counts: {finished}; {steps} "
          f"decode_steps in {dt:.3f} s ({dt * 1e3 / steps:.3f} ms per step; "
          f"plain {dt_p * 1e3 / steps:.3f}); tokens agreeing with the plain "
          f"kernels' run: {agree}/{total}")
    gate(finished, "a batched request did not finish with its token count")
    launch_gates.append(("batched", "decode_attention", launched,
                         depth * steps))

    for label, k, n, want_n in launch_gates:
        if n <= 0 or (want_n is not None and n != want_n):
            failures.append(f"{label}: {k} launched {n} times"
                            + (f", expected {want_n}" if want_n else ""))
    if failures:
        fail("serving path: " + "; ".join(failures))
    return {"decode_attention": cold_counts["decode_attention"]}


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
                                               flash_attention_plain)
    from repro_torch.kernels.attention import visible as attn_visible
    from repro_torch.kernels.conv_winograd import winograd_tile_matmul_plain
    from repro_torch.kernels.matmul import matmul_packed_plain, matmul_plain
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

    def bound(flops, nbytes, dtype="float32"):
        t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def check(label, kernel, plain, library, flops, nbytes,
              dtype="float32", peak=None, exact=False):
        torch.cuda.synchronize()  # inputs were copied on the default stream
        with torch.cuda.stream(stream):
            got, ref = kernel(), plain()
        stream.synchronize()
        got, ref = got.to(torch.float32), ref.to(torch.float32)
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes, peak or dtype)
        print(f"  {label}: max|d|={err:.3e} rel={err / scale:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.6f} ({b_by}, {peak or dtype} peak)")
        tol = 0.0 if exact else KERNEL_TOL[dtype]
        if not torch.isfinite(got).all() or err / scale > tol:
            fail(f"{label}: kernel disagrees with its plain version "
                 f"(rel {err / scale:.3e} > {tol})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    print("kernels vs plain versions (resnet50@224 shapes):")
    results = {}
    wino_shapes = [("stem", 12544, 3, 64), ("stage0", 12544, 64, 64),
                   ("stage1", 3136, 128, 128), ("stage2", 784, 256, 256)]
    for tag, T, C, O in wino_shapes:
        V, U = rand(16, T, C), rand(16, C, O)
        r = check(f"winograd_tile_matmul {tag} (16,{T},{C})x(16,{C},{O})",
                  lambda: ops.winograd_tile_matmul(V, U),
                  lambda: winograd_tile_matmul_plain(V, U),
                  lambda: torch.bmm(V, U),
                  2 * 16 * T * C * O, 4 * 16 * (T * C + C * O + T * O))
        results.setdefault("winograd_tile_matmul", {})[tag] = r
    mm_shapes = [("im2col_s1b0", 12544, 576, 128),
                 ("im2col_s2b0", 3136, 1152, 256), ("head", 1, 256, 100)]
    for tag, M, K, N in mm_shapes:
        x, w = rand(M, K), rand(K, N)
        r = check(f"matmul {tag} ({M},{K})x({K},{N})",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 4 * (M * K + K * N + M * N))
        results.setdefault("matmul", {})[tag] = r
    M, K, N = 1, 256, 100
    x = rand(M, K)
    wp = torch.zeros(1, 2, 128, 128, device=dev)
    wfull = rand(K, N)
    wp.view(2, 128, 128)[:, :, :N] = wfull.view(2, 128, N)
    r = check(f"matmul_packed head ({M},{K})x(1,2,128,128)",
              lambda: ops.matmul_packed(x, wp, K, N),
              lambda: matmul_packed_plain(x, wp, K, N),
              lambda: torch.einsum("mkc,nkcd->mnd", x.view(M, 2, 128), wp),
              # the kernel masks the zero columns of each packed tile, so it
              # reads the K*N real weights and no padding
              2 * M * N * K, 4 * (M * K + K * N + M * N))
    results["matmul_packed"] = {"head": r}

    print("kernels vs plain versions (smollm-360m prefill shapes, bf16):")
    # the seven projections of a block (M = 64 prompt tokens) and the head
    for tag, M, K, N in [("d_model", 64, 960, 960), ("up", 64, 960, 2560),
                         ("down", 64, 2560, 960), ("head", 64, 960, 49152)]:
        x = rand(M, K, dtype=torch.bfloat16)
        w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        r = check(f"matmul_bf16 {tag} ({M},{K})x({K},{N})",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 2 * (M * K + K * N + M * N), "bfloat16")
        results.setdefault("matmul_bf16", {})[tag] = r

    def visible_pairs(S, window):
        rows = np.arange(S)
        return int(np.minimum(rows + 1, window or S).sum())

    # (tag, B, S, H, KV, D, window, softcap, dtype); causal throughout
    for tag, B, S, H, KV, D, win, cap, dt in [
            ("prefill64", 1, 64, 15, 5, 64, None, None, torch.bfloat16),
            ("prefill2048", 1, 2048, 15, 5, 64, None, None, torch.bfloat16),
            ("ragged100", 1, 100, 15, 5, 64, None, None, torch.bfloat16),
            ("f32_window_softcap", 1, 1024, 15, 5, 64, 256, 50.0,
             torch.float32),
            # the other head dims the kernel is built for
            ("d32_window", 2, 200, 8, 2, 32, 64, None, torch.bfloat16),
            ("d128_softcap", 2, 130, 4, 4, 128, None, 30.0, torch.bfloat16)]:
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
        r = check(f"flash_attention {tag} B={B} S={S} H={H} KV={KV} D={D} "
                  f"window={win} softcap={cap} {dname}",
                  lambda: ops.flash_attention(q, k, v, **kw),
                  lambda: flash_attention_plain(q, k, v, **kw), lib,
                  4 * B * H * D * visible_pairs(S, win),
                  q.element_size() * 2 * B * S * (H + KV) * D, dname)
        results.setdefault("flash_attention", {})[tag] = r

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
        r = check(f"decode_attention {tag} B={B} W={W} H={H} KV={KV} D={D} "
                  f"window={window} softcap={softcap} "
                  f"{'int8 cache' if int8 else dname} visible={n_vis}",
                  lambda: ops.decode_attention(q, k, v, p, **kw),
                  lambda: decode_attention_plain(q, k, v, p, **kw), lib,
                  4 * H * D * n_vis,
                  n_vis * entry_b + 2 * B * H * D * es + 4 * B, dname)
        results.setdefault("decode_attention", {})[tag] = r

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
    # up projection in f32 and bf16, a ragged case; operations at the peak
    # of x's type (int8 and int4 weights are exact in bf16, so bf16 x could
    # run at the bf16 tensor-core rate)
    for tag, M, K, N, dt in [
            ("resnet_head", 1, 256, 100, torch.float32),
            ("up_f32", 64, 960, 2560, torch.float32),
            ("up_bf16", 64, 960, 2560, torch.bfloat16),
            ("ragged", 3, 129, 7, torch.float32)]:
        x = rand(M, K, dtype=dt)
        a = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        q8, s8, _ = quant.quantize_int8(a)
        p4, s4 = quant.quantize_int4(a)
        tq8, ts8, tp4, ts4 = (torch.from_numpy(v).to(dev)
                              for v in (q8, s8, p4, s4))
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        io = es * M * K + 4 * N + es * M * N
        r = check(f"matmul_dequant_int8 {tag} ({M},{K})x({K},{N}) {dname}",
                  lambda: ops.matmul_dequant_int8(x, tq8, ts8),
                  lambda: Q.matmul_dequant_int8_plain(x, tq8, ts8), None,
                  2 * M * N * K, io + K * N, dname)
        results.setdefault("matmul_dequant_int8", {})[tag] = r
        r = check(f"matmul_dequant_int4 {tag} ({M},{K})x({K},{N}) {dname}",
                  lambda: ops.matmul_dequant_int4(x, tp4, ts4, K),
                  lambda: Q.matmul_dequant_int4_plain(x, tp4, ts4, K), None,
                  2 * M * N * K, io + (K + 1) // 2 * N, dname)
        results.setdefault("matmul_dequant_int4", {})[tag] = r
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
    torch.cuda.synchronize()
    print(f"  [kernel phases done at {time.perf_counter() - t_start:.1f} s]")
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
        ops.reset_launch_counts()
        for label, pin in runs:
            before = ops.launch_counts()
            if pin is not None:
                eng.set_plan(replace(decided, choices=pin))
            r = eng.run_cold(x_np)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            per_run.append((label, delta))
            print(f"  run_cold [{label}]: total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)}")
            check_output(label, r.output)
        cnn_counts = ops.launch_counts()
        for k in ("matmul", "matmul_packed", "winograd_tile_matmul"):
            launches[k] = cnn_counts[k]
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
        for mode in ("sequential", "nnv12_nosteal"):
            r = eng.run_cold(x_np, mode=mode)
            print(f"  run_cold [{mode}]: total_s={r.total_s:.4f}")
            check_output(mode, r.output)
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
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    print(f"  [CNN path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 5. the cold-LLM path -----------------------------------------------
    launches.update(llm_path(dev, LLM_DEPTH))
    print(f"  [LLM path done at {time.perf_counter() - t_start:.1f} s]")
    launches.update(llm_lossy_path(dev, LOSSY_DEPTH))
    print(f"  [lossy LLM path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 6. the serving path -------------------------------------------------
    launches.update(serving_path(dev, SERVE_DEPTH))
    print(f"  [serving path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 7. report ----------------------------------------------------------
    main_shape = {"winograd_tile_matmul": "stage0", "matmul": "im2col_s1b0",
                  "matmul_packed": "head", "matmul_bf16": "head",
                  "flash_attention": "prefill64",
                  "decode_attention": "B1_W82_bfloat16",
                  "dequant_int8": "head",
                  "dequant_int4": "head",
                  "matmul_dequant_int8": "resnet_head",
                  "matmul_dequant_int4": "resnet_head"}
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
