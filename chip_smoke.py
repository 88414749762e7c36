"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It

  1. prints the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions and the TF32 flags (asserted off);
  2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel) and prints the build time;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes resnet50@224 gives it (max|d|/max|plain| <= 2e-5), and times the
     kernel, the plain version and one library call with CUDA events;
  4. drives the main path: resnet50 at image 224, width 1.0, from
     ``build_cnn`` through ``ColdEngine(store_fmt="super")``, ``decide`` with
     the real profiler, then ``run_cold``, and two more ``run_cold``s under
     pinned plans (Winograd for every 3x3/s1 conv with the packed head;
     im2col for every conv with the direct head), each output held to an
     all-plain forward on the card (max|d|/max|ref| <= 1e-4);
  5. fails unless every kernel launched during the main path and no kernel
     was demoted by the fault ladder.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. With no CUDA device, or without the repository's sources beside
it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# f32 without tensor cores / memory rate, by card (NVIDIA data sheets)
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}

KERNEL_TOL = 2e-5
PATH_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)

    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.registry import ConvDirect
    from repro_torch.core.scheduler import Choice
    from repro_torch.device import resolve_device, set_f32_precision
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import (StageEngine, reset_io_engine,
                                      reset_stage_engine)
    from repro_torch.kernels import _native, ops
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
    peak_flops, peak_bw = PEAKS["pcie" if "PCIe" in name else "sxm"]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print(f"peaks used for bounds: {peak_flops / 1e12:.0f} TFLOP/s f32, "
          f"{peak_bw / 1e12:.2f} TB/s")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _native.load_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({_native.stats['built']} of {len(_native.SOURCES)} libraries "
          f"built, the rest found in {_native.build_dir()})")
    for src, log in _native.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # -- 3. kernels against their plain versions ------------------------------
    stream = torch.cuda.Stream(dev)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

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

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def check(label, kernel, plain, library, flops, nbytes):
        torch.cuda.synchronize()  # inputs were copied on the default stream
        with torch.cuda.stream(stream):
            got, ref = kernel(), plain()
        stream.synchronize()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes)
        print(f"  {label}: max|d|={err:.3e} rel={err / scale:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by})")
        if not torch.isfinite(got).all() or err / scale > KERNEL_TOL:
            fail(f"{label}: kernel disagrees with its plain version "
                 f"(rel {err / scale:.3e} > {KERNEL_TOL})")
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
    torch.cuda.synchronize()

    # -- 4. the main path ---------------------------------------------------
    layers, x_np = build_cnn("resnet50", image=224, width=1.0, classes=100,
                             seed=0)

    def plain_forward(x_in):
        y = torch.from_numpy(x_in).to(dev)
        direct = ConvDirect()
        for l in layers:
            if l.spec.op_type == "stateless":
                y = l.fn(y)
                continue
            w = {k: torch.from_numpy(v).to(dev) for k, v in l.weights.items()}
            if l.spec.op_type == "conv2d":
                y = direct.execute(w, y, l.spec)
            else:
                y = matmul_plain(y, w["w"]) + w["b"]
        torch.cuda.synchronize()
        return y

    ref_out = plain_forward(x_np)
    ref_scale = ref_out.abs().max().item()

    def check_output(label, out):
        out = out.detach()
        if tuple(out.shape) != (1, 100) or not torch.isfinite(out).all():
            fail(f"{label}: output shape {tuple(out.shape)} or non-finite")
        rel = (out - ref_out).abs().max().item() / max(ref_scale, 1e-30)
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
        launches = ops.launch_counts()
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the main path: {repairs} "
                 f"{open_breakers}")
        for k, n in launches.items():
            if n <= 0:
                fail(f"kernel {k} never launched on the main path")
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
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()

    # -- 5. report ----------------------------------------------------------
    main_shape = {"winograd_tile_matmul": "stage0", "matmul": "im2col_s1b0",
                  "matmul_packed": "head"}
    out = []
    for k, (source, replaces) in ops.KERNELS.items():
        r = results[k][main_shape[k]]
        out.append({"name": k, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[k],
                    "shape": main_shape[k], **r})
    print(f"kernels: " + ", ".join(f"{k}={n}" for k, n in launches.items()))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
