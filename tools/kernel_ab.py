"""Time ``decode_attention``, the f32 ``matmul``, ``flash_attention``,
``flash_attention_bwd``, ``winograd_tile_matmul``, ``ssd_scan``,
``ssd_scan_bwd``, ``matmul_packed``, ``matmul_dequant_int8``,
``matmul_dequant_int4``, the f32 ``gmm_blocks`` and the MoE backward's
products (``gmm_blocks`` with w read K-major, ``gmm_blocks_dw``) of one
source tree of the PyTorch port on a CUDA card, so that two commits can be
compared on one card; with ``--only ssm_step`` also the device busy time
of a bf16 mamba2 and zamba2 training step (``ssd_bwd``'s kernels' share
beside it).

Each row calls the tree's own wrapper (``repro_torch.kernels.ops``) at a
decode, GEMM, prefill, Winograd, SSD-scan, packed-GEMM, int8- or
int4-GEMM or expert-GEMM shape of ``chip_smoke.py`` and prints one JSON
object:
``ms``, the mean of 20 calls after 3 warm-ups by CUDA events (the ruler of
``chip_smoke.py``'s kernel rows, host cost included), and ``device_ms``,
the same 20 calls captured in a CUDA graph and replayed (device time),
beside the PyTorch library call (SDPA, ``torch.matmul``, ``torch.bmm``;
``torch.matmul`` on the unpacked weight for ``matmul_packed`` with f32 x,
``torch._weight_int8pack_mm`` for ``matmul_dequant_int8`` where the card
takes it, SDPA's backward through autograd for ``flash_attention_bwd``
(by events only: autograd's backward does not run on a capturing
stream); ``torch.bmm`` on the masked blocks for the MoE backward's rows;
none for ``ssd_scan``, ``ssd_scan_bwd``, ``matmul_dequant_int4``, a
routed f32 ``gmm_blocks`` and a packed bf16 x) timed both ways,
and the output's error against the tree's plain version (the worst of y
and the final state for ``ssd_scan``). A row whose input the tree's
wrapper refuses (the parent's ``matmul_packed`` with a bf16 x) prints
``refused``; so does every ``flash_bwd`` row of a tree that has no
``flash_attention_bwd``, and every ``gmm_bwd`` row of a tree whose
``gmm_blocks`` refuses a K-major w or that has no ``gmm_blocks_dw``.

To compare a parent commit with a change, unpack the parent into a
gitignored directory and run both trees in one call, in the order parent,
change, change, parent:

    git archive HEAD | tar -x -C .archive/parent
    python3 tools/kernel_ab.py --src .archive/parent/src --label parent
    python3 tools/kernel_ab.py --src src --label change --variants

``--variants`` also times plans that the tree's planners (``plan_decode``,
``plan_f32_gemm``, ``plan_flash``) did not pick: ``decode_attention`` in
one launch (no split) where the cache is a few tiles, the f32 skinny path
with K slices of at least 4 and 8 steps, every other cut of
``flash_plans``, and for Winograd the stream path at one block an SM and
the batched tile path's other tiles, and for the f32 ``gmm_blocks`` the
batched tile path's other tiles and the batched skinny path split 2, 4
and 8 ways, and for ``ssd_scan_bwd`` the head groups ``plan_ssd_bwd``
did not pick. ``--ptxas`` prints what ``ptxas -v``
said of each kernel of the libraries the rows built (registers, stack
frame, spills). Rows run for the kernels named by ``--only`` (default:
all eleven). The plan is printed where the tree's wrapper launches along
it. Without a CUDA card it exits 2.

    python3 tools/kernel_ab.py --only ssd_scan --phases
    python3 tools/kernel_ab.py --only packed,dequant_int4,matmul
    python3 tools/kernel_ab.py --only dequant_int8,gmm_f32
    python3 tools/kernel_ab.py --only flash_bwd --phases
    python3 tools/kernel_ab.py --only gmm_bwd
    python3 tools/kernel_ab.py --only ssd_bwd,ssm_step --phases
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ITERS = 20

# (row, B, W, H, KV, D): smollm-360m (15/5 heads), granite-moe-3b-a800m
# (24/8); W 82 is the cold start, W 64 granite's profiled decode
DECODE_ROWS = [("smollm_B1_W82", 1, 82, 15, 5, 64),
               ("smollm_B1_W128", 1, 128, 15, 5, 64),
               ("smollm_B1_W256", 1, 256, 15, 5, 64),
               ("smollm_B1_W512", 1, 512, 15, 5, 64),
               ("smollm_B4_W82", 4, 82, 15, 5, 64),
               ("smollm_B4_W4096", 4, 4096, 15, 5, 64),
               ("granite_B1_W64", 1, 64, 24, 8, 64),
               ("granite_B4_W4096", 4, 4096, 24, 8, 64)]

# (row, B, S, H, KV, D, dtype, window, softcap): the training path's
# attention backward (smollm-360m's microbatch of 4 x 512 and the batch of
# 8 in bf16, the batch of 8 in f32; zamba2-2.7b's microbatch, head dim 80)
# and a windowed, softcapped shape of gemma2's kind
FLASH_BWD_ROWS = [("smollm_mb", 4, 512, 15, 5, 64, "bfloat16", None, None),
                  ("smollm_B8", 8, 512, 15, 5, 64, "bfloat16", None, None),
                  ("zamba2_mb", 4, 512, 32, 32, 80, "bfloat16", None,
                   None),
                  ("smollm_B8_f32", 8, 512, 15, 5, 64, "float32", None,
                   None),
                  ("gemma2_window_softcap", 1, 1024, 32, 16, 128,
                   "bfloat16", 256, 50.0)]

# (row, M, K, N, K-major w): resnet50's im2col GEMMs, granite-moe-3b-a800m's
# router, mamba2-2.7b's f32 decode projections and tied head
# (row, B, S, H, KV, D, dtype): smollm-360m's cold and long prefill,
# granite-moe-3b-a800m's 512-token prefill, zamba2-2.7b's head dim 80
FLASH_ROWS = [("smollm_S64", 1, 64, 15, 5, 64, "bfloat16"),
              ("smollm_S2048", 1, 2048, 15, 5, 64, "bfloat16"),
              ("granite_S512", 1, 512, 24, 8, 64, "bfloat16"),
              ("zamba2_S1024_d80", 1, 1024, 32, 32, 80, "bfloat16"),
              ("zamba2_S1024_d80_f32", 1, 1024, 32, 32, 80, "float32")]

# (row, T, C, O): resnet50@224's 3x3/s1 stages as 16 batched GEMMs
WINO_ROWS = [("stem", 12544, 3, 64), ("stage0", 12544, 64, 64),
             ("stage1", 3136, 128, 128), ("stage2", 784, 256, 256)]

# (row, B, S, H, P, N, Q, dtype, init and d final): ssd_scan's backward at
# chip_smoke.py's four rows: mamba2-2.7b's training microbatch (B 4, S
# 512) in bf16 and f32, zamba2-2.7b's (N 64), and mamba2 at S 1024 from a
# random state under a gradient of the final state
SSD_BWD_ROWS = [("mamba2_mb", 4, 512, 80, 64, 128, 256, "bfloat16", False),
                ("mamba2_mb_f32", 4, 512, 80, 64, 128, 256, "float32",
                 False),
                ("zamba2_mb_N64", 4, 512, 80, 64, 64, 256, "bfloat16", False),
                ("mamba2_S1024_init_dfinal", 1, 1024, 80, 64, 128, 256,
                 "bfloat16", True)]

# (row, arch, layers): the bf16 training steps whose backward runs
# ssd_scan_bwd, at chip_smoke.py's depths and batch (8 x 512 tokens in two
# microbatches, remat, SyntheticPipeline seed 0, weights from seed 0)
SSM_STEP_ROWS = [("mamba2_8_layers", "mamba2-2.7b", 8),
                 ("zamba2_12_layers", "zamba2-2.7b", 12)]
# --variants: ssd_scan_bwd's chunk kernel at these groups of heads too
SSD_BWD_GROUPS = (2, 4, 5, 8, 9, 10, 16, 20)

# (row, B, S, H, P, N, Q, dtype): mamba2-2.7b's scan at S 1024 in bf16
# (its served precision) and f32 (its whole-model gates), zamba2-2.7b's N
# 64, and mamba2's 80 heads cut ten ways (8 heads a card, where 64-row
# tiles alone leave SMs idle)
SSD_ROWS = [("mamba2_S1024", 1, 1024, 80, 64, 128, 256, "bfloat16"),
            ("mamba2_S1024_f32", 1, 1024, 80, 64, 128, 256, "float32"),
            ("zamba2_S1024_N64", 1, 1024, 80, 64, 64, 256, "bfloat16"),
            ("mamba2_S1024_H8", 1, 1024, 8, 64, 128, 256, "bfloat16")]

MATMUL_ROWS = [("im2col_s1b0", 12544, 576, 128, False),
               ("im2col_s2b0", 3136, 1152, 256, False),
               ("granite_router_M1", 1, 1536, 40, False),
               ("granite_router_M4", 4, 1536, 40, False),
               ("granite_router_prefill", 512, 1536, 40, False),
               ("mamba2_in_M1", 1, 2560, 5120, False),
               ("mamba2_bc_M1", 1, 2560, 128, False),
               ("mamba2_dt_M1", 1, 2560, 80, False),
               ("mamba2_out_M1", 1, 5120, 2560, False),
               ("mamba2_head_tied_M1", 1, 2560, 50280, True),
               # the yardsticks of the packed and int4 rows
               ("head", 1, 256, 100, False),
               ("up_f32", 64, 960, 2560, False)]

# (row, M, K, N, x dtype): resnet50's packed and int4 heads, a tblock up
# projection of smollm-360m in f32 and bf16 x, ragged edges, and for int4
# a decode projection at M 1 (16-byte loads)
PACKED_ROWS = [("head", 1, 256, 100, "float32"),
               ("up_f32", 64, 960, 2560, "float32"),
               ("up_bf16", 64, 960, 2560, "bfloat16"),
               ("ragged_tile", 64, 300, 150, "float32")]
DQ4_ROWS = [("resnet_head", 1, 256, 100, "float32"),
            ("up_f32", 64, 960, 2560, "float32"),
            ("up_bf16", 64, 960, 2560, "bfloat16"),
            ("ragged", 3, 129, 7, "float32"),
            ("up_M1", 1, 960, 2560, "float32")]
# matmul_dequant_int8 at chip_smoke.py's int8 rows: the resnet50 head, the
# up projection in f32 and bf16 x, decode at M 1 and 8, ragged edges
DQ8_ROWS = [("resnet_head", 1, 256, 100, "float32"),
            ("up_f32", 64, 960, 2560, "float32"),
            ("up_bf16", 64, 960, 2560, "bfloat16"),
            ("ragged", 3, 129, 7, "float32"),
            ("up_M1", 1, 960, 2560, "float32"),
            ("up_M8", 8, 960, 2560, "bfloat16"),
            ("ragged_tile", 64, 129, 100, "bfloat16"),
            ("ragged_tile_bytes", 20, 37, 7, "float32")]
# (row, E, C, d, n, routed tokens): the f32 gmm_blocks at
# granite-moe-3b-a800m's gate projection, decode C 8 without group sizes
# and routed for 1 and 4 tokens (top-8 of 40), a 512-token prefill C 208,
# and the Pallas sweep's 8x128x128x128
GMM_F32_ROWS = [("decode_gate_f32", 40, 8, 1536, 512, None),
                ("decode_gate_routed_T1_f32", 40, 8, 1536, 512, 1),
                ("decode_gate_routed_T4_f32", 40, 8, 1536, 512, 4),
                ("prefill_gate_f32", 40, 208, 1536, 512, None),
                ("sweep_8x128x128x128_f32", 8, 128, 128, 128, None)]

# (row, product, E, C, K, N, dtype, routed): the MoE backward at
# granite-moe-3b-a800m's training microbatch (2048 tokens, top-8 of 40, C
# 824): dx = dy (E,C,K)·wᵀ with w stored (E,N,K) and read K-major (dh: K
# 1536, N 512; dblk: K 512, N 1536) and dw = x (E,C,K)ᵀ·dy (E,C,N) over
# each expert's rows (dwg: K 1536, N 512; dwd: K 512, N 1536), bf16 and
# f32, a top-8 routing's group sizes and all experts full
GMM_BWD_ROWS = [(f"{prod}_{g}{'' if dt == 'bfloat16' else '_f32'}", kind,
                 40, 824, K, N, dt, g == "routed")
                for dt in ("bfloat16", "float32")
                for g in ("routed", "full")
                for prod, kind, K, N in (("dh", "dx", 1536, 512),
                                         ("dblk", "dx", 512, 1536),
                                         ("dwg", "dw", 1536, 512),
                                         ("dwd", "dw", 512, 1536))]

# the kernel library each --only name launches
LIBRARY = {"decode": "decode_attention", "matmul": "matmul",
           "flash": "flash_attention", "flash_bwd": "flash_attention_bwd",
           "winograd": "conv_winograd",
           "ssd_scan": "ssd", "ssd_bwd": ("ssd", "ssd_bwd"),
           "ssm_step": ("matmul", "flash_attention", "flash_attention_bwd",
                        "ssd", "ssd_bwd"),
           "packed": "matmul", "dequant_int8": "quant",
           "dequant_int4": "quant", "gmm_f32": "gmm",
           "gmm_bwd": ("gmm", "gmm_dw")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src",
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--phases", action="store_true",
                    help="also print each row's kernels by device time "
                         "(torch.profiler over 10 calls)")
    ap.add_argument("--only", default="decode,matmul,flash,flash_bwd,"
                    "winograd,ssd_scan,ssd_bwd,packed,dequant_int8,"
                    "dequant_int4,gmm_f32,gmm_bwd",
                    help="comma-separated: decode, matmul, flash, "
                         "flash_bwd, winograd, ssd_scan, ssd_bwd, packed, "
                         "dequant_int8, dequant_int4, gmm_f32, gmm_bwd, "
                         "ssm_step (not in the default)")
    args = ap.parse_args()
    only = set(args.only.split(","))

    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import ops

    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"kernel_ab: imported {repro_torch.__file__}, "
                         f"not the tree under {src}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "src": args.src, "card": smi,
                      "torch": torch.__version__}), flush=True)
    stream = torch.cuda.Stream(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def time_ms(fn):
        with torch.cuda.stream(stream):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(ITERS):
                fn()
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    def device_ms(fn):
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                for _ in range(ITERS):
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
            return start.elapsed_time(end) / (3 * ITERS)
        except Exception as e:  # reported as not measured
            torch.cuda.synchronize()
            print(json.dumps({"label": args.label, "no_graph":
                              f"{type(e).__name__}: {e}"}), flush=True)
            return None

    def row(kernel, name, fn, plain, library, plan=None,
            library_graph=True, profiled=False):
        torch.cuda.synchronize()
        try:
            with torch.cuda.stream(stream):
                got, ref = fn(), plain()
            stream.synchronize()
        except (ValueError, TypeError) as e:  # an input the tree refuses
            print(json.dumps({"label": args.label, "kernel": kernel,
                              "row": name, "refused": str(e)}), flush=True)
            return
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = max(((g.float() - r.float()).abs().max()
                   / r.float().abs().max().clamp_min(1e-30)).item()
                  for g, r in pairs)
        rec = {"label": args.label, "kernel": kernel, "row": name,
               "plan": plan, "rel_err": err, "ms": time_ms(fn),
               "device_ms": device_ms(fn),
               "library_ms": library and time_ms(library),
               "library_device_ms": (library and library_graph
                                     and device_ms(library)) or None}
        if args.phases:
            rec["phases_ms"] = phases(fn)
        if profiled:   # one ruler for the kernel and an uncapturable library
            rec["profiled_ms"] = sum(phases(fn).values())
            rec["library_profiled_ms"] = (library
                                          and sum(phases(library).values()))
        print(json.dumps(rec), flush=True)

    def phases(fn, n=10):
        """Device ms a call of each kernel that ``fn`` launches, by name
        (``torch.profiler``, the calls on the row's stream, as
        ``chip_smoke.py``'s ``profiled_ms`` takes them)."""
        from torch.profiler import ProfilerActivity, profile
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(stream):
                for _ in range(n):
                    fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.self_device_time_total <= 0:
                continue
            m = re.search(r"(\w+_kernel)(<[^()]*>)?", e.key)
            key = (m.group(0) if m else e.key)[:80]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / n
        return out

    # the libraries the chosen rows launch, built together (one nvcc each)
    from repro_torch.kernels import _native
    libs = {lib for k in only
            for lib in ((LIBRARY[k],) if isinstance(LIBRARY[k], str)
                        else LIBRARY[k])} & set(_native.SOURCES)
    if "flash_bwd" in only:    # its rows run the forward for o and lse
        libs.add("flash_attention")
    _native.build_all(sorted(libs))

    has_plans = hasattr(A, "plan_decode") and hasattr(MM, "plan_f32_gemm")
    if args.variants and not has_plans:
        raise SystemExit("kernel_ab: --variants needs plan_decode and "
                         "plan_f32_gemm")

    for name, B, W, H, KV, D in DECODE_ROWS if "decode" in only else []:
        q = rand(B, H, D, dtype=torch.bfloat16)
        k = rand(B, W, KV, D, dtype=torch.bfloat16)
        v = rand(B, W, KV, D, dtype=torch.bfloat16)
        pos = torch.full((B,), W - 1, dtype=torch.int32, device=dev)
        qs, kt, vt = (q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous())

        def lib():
            return F.scaled_dot_product_attention(qs, kt, vt,
                                                  enable_gqa=True)

        def call():
            return ops.decode_attention(q, k, v, pos)

        def plain():
            return A.decode_attention_plain(q, k, v, pos)

        plan = A.plan_decode(B, W, H, KV, D) if has_plans else None
        row("decode_attention", name, call, plain, lib,
            plan and {"split": plan.split, "chunk": plan.chunk})
        if args.variants and plan.split > 1 and plan.tiles <= 8:
            orig = A.plan_decode
            one = plan._replace(chunk=plan.tiles * plan.tile, split=1,
                                blocks=plan.blocks // plan.split)
            A.plan_decode = lambda *a: one
            try:
                row("decode_attention", name + "_one_launch", call, plain,
                    lib, {"split": 1, "chunk": one.chunk})
            finally:
                A.plan_decode = orig

    for name, M, K, N, kmajor in MATMUL_ROWS if "matmul" in only else []:
        x = rand(M, K)
        w = rand(N, K).T if kmajor else rand(K, N)

        def call():
            return ops.matmul(x, w)

        def plain():
            return MM.matmul_plain(x, w)

        def lib():
            return torch.matmul(x, w)

        plan = MM.plan_f32_gemm(M, N, K, kmajor) if has_plans else None
        row("matmul", name, call, plain, lib,
            plan and {"path": plan.path, "tile": [plan.bm, plan.bn],
                      "split": plan.split})
        if args.variants and plan.path == "skinny" and plan.split > 1:
            orig = MM.plan_f32_gemm
            tiles = plan.blocks // plan.split
            for least in (4, 8):
                split = max(d for d in range(1, plan.ksteps + 1)
                            if plan.ksteps % d == 0
                            and plan.ksteps // d >= least)
                if split >= plan.split:
                    continue
                var = plan._replace(split=split, blocks=tiles * split)
                MM.plan_f32_gemm = lambda *a: var
                try:
                    row("matmul", f"{name}_ksteps{least}", call, plain, lib,
                        {"path": "skinny", "split": split})
                finally:
                    MM.plan_f32_gemm = orig

    for name, B, S, H, KV, D, dname in FLASH_ROWS if "flash" in only else []:
        dt = getattr(torch, dname)
        q = rand(B, S, H, D, dtype=dt)
        k = rand(B, S, KV, D, dtype=dt)
        v = rand(B, S, KV, D, dtype=dt)

        def call():
            return ops.flash_attention(q, k, v, causal=True)

        def plain():
            return A.flash_attention_plain(q, k, v, causal=True)

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        has_flash = hasattr(A, "plan_flash")
        plan = (A.plan_flash(B, S, H, KV, D, dt, True, None) if has_flash
                else None)
        row("flash_attention", name, call, plain, lib,
            plan and plan._asdict())
        if args.variants and has_flash:
            orig = A.plan_flash
            for var in A.flash_plans(B, S, H, KV, D, dt):
                if var == plan:
                    continue
                A.plan_flash = lambda *a, var=var: var
                try:
                    row("flash_attention",
                        f"{name}_bq{var.bq}_h{var.heads}_ks{var.ksplit}",
                        call, plain, lib, var._asdict())
                finally:
                    A.plan_flash = orig

    for name, B, S, H, KV, D, dname, win, cap in (
            FLASH_BWD_ROWS if "flash_bwd" in only else []):
        if not hasattr(ops, "flash_attention_bwd"):
            print(json.dumps({"label": args.label,
                              "kernel": "flash_attention_bwd", "row": name,
                              "refused": "no flash_attention_bwd in this "
                                         "tree"}), flush=True)
            continue
        dt = getattr(torch, dname)
        q, k, v = (rand(B, S, n, D, dtype=dt) * 0.5 for n in (H, KV, KV))
        do = rand(B, S, H, D, dtype=dt)
        kw = dict(causal=True, window=win, softcap=cap)
        with torch.cuda.stream(stream):
            o, lse = A._flash_forward(q, k, v, True, win, cap, True)
            lib = None
            if win is None and cap is None:
                ins = [t.transpose(1, 2).detach().requires_grad_()
                       for t in (q, k, v)]
                ot = F.scaled_dot_product_attention(*ins, is_causal=True,
                                                    enable_gqa=True)

                def lib(ot=ot, ins=ins, g=do.transpose(1, 2)):
                    return torch.autograd.grad(ot, ins, g, retain_graph=True)
        stream.synchronize()

        def call():
            return ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)

        def plain():
            return A.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)

        plan = {"window": win, "softcap": cap}
        if hasattr(A, "plan_flash_bwd"):
            plan.update(A.plan_flash_bwd(B, S, H, KV, D, dt, True,
                                         win)._asdict())
        row("flash_attention_bwd", name, call, plain, lib, plan,
            library_graph=False, profiled=True)
        if args.variants and plan.get("route") == "mma":
            # the other dK/dV split
            orig = A.plan_flash_bwd
            var = orig(B, S, H, KV, D, dt, True, win)
            var = var._replace(split=3 - var.split)
            A.plan_flash_bwd = lambda *a, var=var: var
            try:
                row("flash_attention_bwd", f"{name}_split{var.split}", call,
                    plain, None, var._asdict())
            finally:
                A.plan_flash_bwd = orig

    from repro_torch.kernels import conv_winograd as CW
    for name, T, C, O in WINO_ROWS if "winograd" in only else []:
        V, U = rand(16, T, C), rand(16, C, O)

        def call():
            return ops.winograd_tile_matmul(V, U)

        def plain():
            return CW.winograd_tile_matmul_plain(V, U)

        def lib():
            return torch.bmm(V, U)

        batched = "batch" in MM.plan_f32_gemm.__wrapped__.__code__.co_varnames
        plan = MM.plan_f32_gemm(T, O, C, False, 16) if batched else None
        row("winograd_tile_matmul", name, call, plain, lib,
            plan and plan._asdict())
        if args.variants and batched:
            ksteps = plan.ksteps
            vars_ = []
            if plan.path == "stream":
                vars_.append(plan._replace(blocks=min(plan.blocks, MM.SMS)))
            for bm in MM.F32_TILE_BM:
                for bn in MM.F32_TILE_BN:
                    tiles = 16 * -(-T // bm) * -(-O // bn)
                    vars_.append(MM.GemmPlan("tile", bm, bn, 1, ksteps,
                                             tiles))
            orig = CW.plan_f32_gemm
            for var in vars_:
                if var == plan:
                    continue
                CW.plan_f32_gemm = lambda *a, var=var: var
                try:
                    row("winograd_tile_matmul",
                        f"{name}_{var.path}_{var.bm}x{var.bn}_{var.blocks}",
                        call, plain, lib, var._asdict())
                finally:
                    CW.plan_f32_gemm = orig

    from repro_torch.kernels import ssd as SSD
    for name, B, S, H, P, N, Q, dname in SSD_ROWS if "ssd_scan" in only \
            else []:
        dt = getattr(torch, dname)
        x = rand(B, S, H, P, dtype=dt) * 0.3
        sdt = rand(B, S, H).abs() * 0.3
        a_neg = -torch.linspace(0.5, 2.0, H, device=dev)
        Bm, Cm = rand(B, S, N, dtype=dt) * 0.3, rand(B, S, N, dtype=dt) * 0.3
        D = torch.ones(H, device=dev)

        def call():
            return ops.ssd_scan(x, sdt, a_neg, Bm, Cm, D, chunk=Q)

        def plain():
            return SSD.ssd_scan_plain(x, sdt, a_neg, Bm, Cm, D, chunk=Q)

        plan = (SSD.plan_ssd(B, S, H, P, N, Q, dt)
                if hasattr(SSD, "plan_ssd") else None)
        row("ssd_scan", name, call, plain, None,
            plan and {"blocks": plan.blocks})

    for name, B, S, H, P, N, Q, dname, init in (
            SSD_BWD_ROWS if "ssd_bwd" in only else []):
        dt = getattr(torch, dname)
        x = rand(B, S, H, P, dtype=dt) * 0.3
        sdt = rand(B, S, H).abs() * 0.3
        a_neg = -torch.linspace(0.5, 2.0, H, device=dev)
        Bm, Cm = rand(B, S, N, dtype=dt) * 0.3, rand(B, S, N, dtype=dt) * 0.3
        D = rand(H)
        st = rand(B, H, P, N) * 0.3 if init else None
        dy = rand(B, S, H, P, dtype=dt)
        dfin = rand(B, H, P, N) if init else None
        with torch.cuda.stream(stream):
            _, _, (cum, cb, ins) = SSD._ssd_forward(x, sdt, a_neg, Bm, Cm, D,
                                                    Q, st, True)
        stream.synchronize()

        def call():
            return ops.ssd_scan_bwd(x, sdt, a_neg, Bm, Cm, D, cum, cb, ins,
                                    dy, dfin)

        def plain():
            return SSD.ssd_scan_bwd_plain(x, sdt, a_neg, Bm, Cm, D, cum, cb,
                                          ins, dy, dfin)

        has_plan = hasattr(SSD, "plan_ssd_bwd")
        plan = SSD.plan_ssd_bwd(B, S, H, P, N, Q, dt) if has_plan else None
        row("ssd_scan_bwd", name, call, plain, None,
            plan and plan._asdict())
        if args.variants and has_plan:   # the head groups not picked
            orig = SSD.plan_ssd_bwd
            for hg in SSD_BWD_GROUPS:
                if hg == plan.heads or hg > H:
                    continue
                var = SSD.ssd_bwd_plan(B, S, H, P, N, Q, dt, hg)
                SSD.plan_ssd_bwd = lambda *a, var=var: var
                try:
                    row("ssd_scan_bwd", f"{name}_heads{hg}", call, plain,
                        None, var._asdict())
                finally:
                    SSD.plan_ssd_bwd = orig
        del x, sdt, Bm, Cm, dy, cum, cb, ins

    for name, arch, layers in SSM_STEP_ROWS if "ssm_step" in only else []:
        # one bf16 training step's device busy time (every kernel's device
        # time under torch.profiler, two steps after one to warm up) and
        # its ssd_scan_bwd kernels' share
        import dataclasses

        from torch.profiler import ProfilerActivity, profile

        from repro_torch import pytree
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticPipeline
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw_init
        from repro_torch.train import make_train_step

        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        for p in pytree.leaves(params):
            p.requires_grad_(True)
        batch = SyntheticPipeline(cfg, 8, 512, microbatches=2, seed=0,
                                  device=dev).batch_at(0)
        step = make_train_step(cfg, lr=3e-3, warmup=5, total_steps=10,
                               num_microbatches=2, remat=True)
        state = [params, adamw_init(params)]

        def one():
            state[0], state[1], _ = step(state[0], state[1], batch)

        one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                one()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / 2
        bwd = sum(e.self_device_time_total for e in kern
                  if "ssd_bwd" in e.key) / 1e3 / 2
        print(json.dumps({"label": args.label, "kernel": "ssm_step",
                          "row": name, "busy_ms": busy,
                          "ssd_bwd_ms": bwd}), flush=True)
        del params, state, batch
        torch.cuda.empty_cache()

    for name, M, K, N, dname in PACKED_ROWS if "packed" in only else []:
        dt = getattr(torch, dname)
        nK, nN = -(-K // 128), -(-N // 128)
        x = rand(M, K, dtype=dt)
        wfull = rand(K, N) * K ** -0.5
        wpad = torch.zeros(nK * 128, nN * 128, device=dev)
        wpad[:K, :N] = wfull
        wp = wpad.view(nK, 128, nN, 128).permute(2, 0, 1, 3).contiguous()

        def call():
            return ops.matmul_packed(x, wp, K, N)

        def plain():
            return MM.matmul_packed_plain(x, wp, K, N)

        def lib():
            return x @ wfull

        plan = MM.plan_f32_gemm(M, N, K) if has_plans else None
        row("matmul_packed", name, call, plain,
            lib if dt == torch.float32 else None,
            plan and {"path": plan.path, "tile": [plan.bm, plan.bn],
                      "split": plan.split})

    from repro_torch import quant as RQ
    from repro_torch.kernels import quant as KQ
    for name, M, K, N, dname in DQ4_ROWS if "dequant_int4" in only else []:
        dt = getattr(torch, dname)
        x = rand(M, K, dtype=dt)
        a = (rand(K, N) * K ** -0.5).cpu().numpy()
        p4, s4 = (torch.from_numpy(v).to(dev) for v in RQ.quantize_int4(a))

        def call():
            return ops.matmul_dequant_int4(x, p4, s4, K)

        def plain():
            return KQ.matmul_dequant_int4_plain(x, p4, s4, K)

        plan = MM.plan_f32_gemm(M, N, K) if has_plans else None
        q_loader = getattr(KQ, "q_loader", getattr(KQ, "int4_loader", None))
        loader = q_loader(p4, M, plan.path) if q_loader else None
        row("matmul_dequant_int4", name, call, plain, None,
            plan and {"path": plan.path, "tile": [plan.bm, plan.bn],
                      "split": plan.split, "loader_bytes": loader})

    # a tree whose int8 wrapper launches along plan_f32_gemm has q_loader
    int8_planned = hasattr(KQ, "q_loader")
    for name, M, K, N, dname in DQ8_ROWS if "dequant_int8" in only else []:
        dt = getattr(torch, dname)
        x = rand(M, K, dtype=dt)
        a = (rand(K, N) * K ** -0.5).cpu().numpy()
        q8, s8, _ = RQ.quantize_int8(a)
        q8, s8 = torch.from_numpy(q8).to(dev), torch.from_numpy(s8).to(dev)
        qT, sv = q8.T.contiguous(), s8.view(-1)

        def call():
            return ops.matmul_dequant_int8(x, q8, s8)

        def plain():
            return KQ.matmul_dequant_int8_plain(x, q8, s8)

        def lib():
            return torch._weight_int8pack_mm(x, qT, sv)

        try:
            lib()
            torch.cuda.synchronize()
        except RuntimeError as e:  # the card refuses it for this dtype
            torch.cuda.synchronize()
            print(json.dumps({"label": args.label, "kernel":
                              "matmul_dequant_int8", "row": name,
                              "library_refused": str(e).splitlines()[0]}),
                  flush=True)
            lib = None
        plan = MM.plan_f32_gemm(M, N, K) if int8_planned else None
        row("matmul_dequant_int8", name, call, plain, lib,
            plan and {"path": plan.path, "tile": [plan.bm, plan.bn],
                      "split": plan.split,
                      "loader_bytes": KQ.q_loader(q8, M, plan.path)})

    from repro_torch.kernels import gmm as GMM
    # a tree whose f32 gmm_blocks launches along plan_f32_gemm takes
    # row_limit
    gmm_planned = ("row_limit"
                   in MM.plan_f32_gemm.__wrapped__.__code__.co_varnames)
    for name, E, C, d, n, tokens in GMM_F32_ROWS if "gmm_f32" in only \
            else []:
        x, w = rand(E, C, d), rand(E, d, n) * d ** -0.5
        gs = None
        if tokens:
            picks = torch.cat([torch.randperm(E, generator=gen,
                                              device=dev)[:8]
                               for _ in range(tokens)])
            gs = torch.bincount(picks, minlength=E).to(torch.int32)

        def call():
            return ops.gmm_blocks(x, w, gs)

        def plain():
            return GMM.gmm_blocks_plain(x, w, gs)

        def lib():
            return torch.bmm(x, w)

        plan = (MM.plan_f32_gemm(C, n, d, False, E, True) if gmm_planned
                else None)
        row("gmm_blocks", name, call, plain, None if tokens else lib,
            plan and {"path": plan.path, "tile": [plan.bm, plan.bn],
                      "split": plan.split})
        if not (args.variants and gmm_planned):
            continue
        if plan.path == "tile":   # every other tile, unsplit
            vars_ = [MM.GemmPlan("tile", bm, bn, 1, plan.ksteps,
                                 E * -(-C // bm) * -(-n // bn))
                     for bm in MM.F32_TILE_BM for bn in MM.F32_TILE_BN]
        else:                     # the skinny path split 2, 4 and 8 ways
            tiles = plan.blocks // plan.split
            vars_ = [plan._replace(split=sp, blocks=tiles * sp)
                     for sp in (2, 4, 8) if plan.ksteps % sp == 0]
        orig = GMM.plan_f32_gemm
        for var in vars_:
            if var == plan:
                continue
            GMM.plan_f32_gemm = lambda *a, var=var: var
            try:
                row("gmm_blocks",
                    f"{name}_{var.path}_{var.bm}x{var.bn}_split{var.split}",
                    call, plain, None if tokens else lib,
                    {"path": var.path, "tile": [var.bm, var.bn],
                     "split": var.split})
            finally:
                GMM.plan_f32_gemm = orig

    for name, kind, E, C, K, N, dname, routed in (
            GMM_BWD_ROWS if "gmm_bwd" in only else []):
        if kind == "dw" and not hasattr(ops, "gmm_blocks_dw"):
            print(json.dumps({"label": args.label, "kernel": "gmm_blocks_dw",
                              "row": name, "refused": "no gmm_blocks_dw in "
                                                      "this tree"}),
                  flush=True)
            continue
        dt = getattr(torch, dname)
        if routed:
            picks = torch.cat([torch.randperm(E, generator=gen,
                                              device=dev)[:8]
                               for _ in range(2048)])
            gs = torch.bincount(picks, minlength=E).clamp(max=C).to(
                torch.int32)
        else:
            gs = torch.full((E,), C, dtype=torch.int32, device=dev)
        keep = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        x = rand(E, C, K, dtype=dt)
        xm = torch.where(keep, x, torch.zeros((), dtype=dt, device=dev))
        if kind == "dx":
            wt = (rand(E, N, K) * K ** -0.5).to(dt).transpose(1, 2)

            def call(x=x, wt=wt, gs=gs):
                return ops.gmm_blocks(x, wt, gs)

            def plain(x=x, wt=wt, gs=gs):
                return GMM.gmm_blocks_plain(x, wt, gs)

            def lib(xm=xm, wt=wt):
                return torch.bmm(xm, wt)
        else:
            dy = rand(E, C, N, dtype=dt)
            dym = torch.where(keep, dy, torch.zeros((), dtype=dt,
                                                    device=dev))

            def call(x=x, dy=dy, gs=gs):
                return ops.gmm_blocks_dw(x, dy, gs)

            def plain(x=x, dy=dy, gs=gs):
                return GMM.gmm_blocks_dw_plain(x, dy, gs)

            def lib(xm=xm, dym=dym):
                return torch.bmm(xm.transpose(1, 2), dym)
        plan = {"rows": int(gs.sum()), "experts": E, "C": C}
        if kind == "dw" and hasattr(GMM, "plan_gmm_dw"):
            plan.update(GMM.plan_gmm_dw(K, N, C, E, dt)._asdict())
        row("gmm_blocks" if kind == "dx" else "gmm_blocks_dw", name, call,
            plain, lib, plan)

    if args.ptxas:
        for lib_name, log in _native.build_logs.items():
            fn = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    fn = m.group(1)
                elif "Used" in line or "stack frame" in line:
                    print(json.dumps({"label": args.label, "lib": lib_name,
                                      "fn": fn, "ptxas": line.strip()}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
