"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. The build happens at first use
(never at import: the CPU tests import every module) into
``$REPRO_TORCH_BUILD_DIR`` or ``src/repro_torch/_build/``. A library's file
name carries a digest of its sources and flags, so an edited kernel never
loads a stale build. ``build_all`` starts one ``nvcc`` per source, all at
once, and waits for them together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, so a refused launch (too many threads,
too much shared memory, no kernel image for this card) never passes
unseen.

The dry run and the step counter (``roofline.op_cost``). A wrapper that a
model step reaches is ``costed``: each outermost call reports the kernel's
cost to every registered counter (``cost_sinks``), the FLOPs the function
computes and the bytes it must move (each input read once, each output
written once: the ``bound_ms`` column's count), and the aten ops it issues
inside (its plain version on the CPU, its outputs and scratch on the
card) are not counted again (``inside_kernel``). On ``meta`` tensors
(shape and dtype, no data) a costed wrapper's ``on_cpu(..., meta=True)``
checks them as it checks CUDA tensors and returns False, and the wrapper
returns empty ``meta`` outputs of the kernel's shapes and dtypes before
any launch: it never runs its plain version there. The other wrappers
refuse meta tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("matmul", "conv_winograd", "flash_attention", "flash_attention_bwd",
           "decode_attention", "quant", "gmm", "gmm_dw", "ssd",
           "ssd_bwd")  # csrc/<name>.cu
HEADERS = ("gemm_f32_paths.cuh", "gemm_bf16_tc.cuh", "ssd_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    # x, w, out, M, N, K, ldb, b_kmajor, path, bm, bn, split, scratch, stream
    "repro_matmul_f32": [_P, _P, _P] + [_I] * 9 + [_P, _P],
    # x, w, out, M, N, K, ldb, b_kmajor, path, bm, split, scratch, stream
    "repro_matmul_bf16": [_P, _P, _P] + [_I] * 8 + [_P, _P],
    "repro_matmul_bf16_f32out": [_P, _P, _P] + [_I] * 8 + [_P, _P],
    # x, w_packed, out, M, N, K, nK, path, bm, bn, split, scratch, stream
    "repro_matmul_packed_f32": [_P, _P, _P] + [_I] * 8 + [_P, _P],
    "repro_matmul_packed_bf16": [_P, _P, _P] + [_I] * 8 + [_P, _P],
    # V, U, out, P, T, C, O, path, bm, bn, split, blocks, scratch, stream
    "repro_winograd_tile_matmul_f32": [_P, _P, _P] + [_I] * 9 + [_P, _P],
    # q, k, v, o, lse (or null), B, S, H, KV, D, causal, window, softcap,
    # bq, heads, ksplit, dp, stream
    "repro_flash_attention_f32": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 4
    + [_P],
    "repro_flash_attention_bf16": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 4
    + [_P],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
    # window, softcap, dp, [route, split (bf16),] stream
    "repro_flash_attention_bwd_f32": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
    "repro_flash_attention_bwd_bf16": [_P] * 10 + [_I] * 7
    + [_F, _I, _I, _I, _P],
    # q, k, v, k_scale, v_scale, pos, o, scratch, B, W, H, KV, D, window,
    # softcap, hg, hgroups, lpr, chunk, split, stream
    "repro_decode_attention_f32": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 5
    + [_P],
    "repro_decode_attention_bf16": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 5
    + [_P],
    "repro_dequant_int8": [_P, _P, _P, _I, _I, _P],
    "repro_dequant_int4": [_P, _P, _P, _I, _I, _P],
    # x, q (int8 or packed int4), scale, out, M, N, K, path, bm, bn,
    # split, scratch, stream
    "repro_matmul_dequant_int8_f32": [_P] * 4 + [_I] * 7 + [_P, _P],
    "repro_matmul_dequant_int8_bf16": [_P] * 4 + [_I] * 7 + [_P, _P],
    "repro_matmul_dequant_int4_f32": [_P] * 4 + [_I] * 7 + [_P, _P],
    "repro_matmul_dequant_int4_bf16": [_P] * 4 + [_I] * 7 + [_P, _P],
    # x, w, out, group_sizes, E, C, d, n, kmajor, path, bm, [bn,] split,
    # scratch, stream
    "repro_gmm_blocks_f32": [_P] * 4 + [_I] * 9 + [_P, _P],
    "repro_gmm_blocks_bf16": [_P] * 4 + [_I] * 8 + [_P, _P],
    # x, dy, out, group_sizes, E, C, d, n, path, bm, [bn,] split, scratch,
    # stream (x read M-major in place)
    "repro_gmm_blocks_dw_f32": [_P] * 4 + [_I] * 8 + [_P, _P],
    "repro_gmm_blocks_dw_bf16": [_P] * 4 + [_I] * 7 + [_P, _P],
    # x, dy, out, group_sizes, E, C, d, n, blocks, stream
    "repro_gmm_blocks_dw_tma_bf16": [_P] * 4 + [_I] * 5 + [_P],
    # x, dt, A, Bm, Cm, D, init, y, final, cum, cb, states, B, S, H, P, N,
    # Q, stream
    "repro_ssd_scan_f32": [_P] * 12 + [_I] * 6 + [_P],
    "repro_ssd_scan_bf16": [_P] * 12 + [_I] * 6 + [_P],
    # x, dt, A, Bm, Cm, D, cum, cb, ins, dy, dfinal, dx, ddt, dA, dBm, dCm,
    # dD, dinit, ds, dlast, dbc, dcb, dcum, dd, insb, B, S, H, P, N, Q,
    # heads, stream
    "repro_ssd_scan_bwd_f32": [_P] * 25 + [_I] * 7 + [_P],
    "repro_ssd_scan_bwd_bf16": [_P] * 25 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
stats = {"build_s": 0.0, "built": 0}
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR") or (_PKG / "_build"))


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC or CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_digest(name)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every missing library in ``names`` (default: all), one ``nvcc``
    per source started together. Raises with the compiler's output when a
    build fails."""
    names = list(SOURCES if names is None else names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc rc={p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
            stats["built"] += 1
    stats["build_s"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in ARGTYPES.items():
                f = getattr(lib, fn, None)
                if f is not None:
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel library."""
    with _lock:
        build_all()
    return {n: library(n) for n in SOURCES}


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


# the current stream's raw handle in one call (what torch's own generated
# code uses); a torch built without CUDA has none, and never launches
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, where a kernel
    launches; cheaper than ``torch.cuda.current_stream(device)``, which
    builds a Stream object on every decode step's call."""
    if _raw_stream is None:
        return torch.cuda.current_stream(device).cuda_stream
    idx = device.index
    return _raw_stream(torch.cuda.current_device() if idx is None else idx)


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device for a launch,
    or nothing when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# -- cost accounting ----------------------------------------------------------
# callables (kernel, flops, bytes, out) that the step counters register
# while they count
cost_sinks: List[Callable[[str, float, float, Any], None]] = []
_tls = threading.local()


def inside_kernel() -> bool:
    """True while this thread runs inside a costed wrapper, whose ops the
    wrapper's own cost stands for."""
    return getattr(_tls, "depth", 0) > 0


def costed(kernel: str, cost: Callable[..., Tuple[float, float]]):
    """Decorator for a kernel wrapper: ``cost(out, *args, **kwargs)``
    gives (flops, bytes) of one call from its arguments' and outputs'
    shapes (never their values: no host sync), reported with the outputs
    to every registered counter once the outermost costed call returns.
    With no counter registered the wrapper runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not cost_sinks:
                return fn(*args, **kwargs)
            depth = getattr(_tls, "depth", 0)
            _tls.depth = depth + 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _tls.depth = depth
            if depth == 0:
                flops, nbytes = cost(out, *args, **kwargs)
                for sink in list(cost_sinks):
                    sink(kernel, float(flops), float(nbytes), out)
            return out
        return inner
    return wrap


def on_cpu(kernel: str, *ts,
           dtypes: Tuple[torch.dtype, ...] = (torch.float32,),
           each: Optional[Sequence[Tuple[torch.dtype, ...]]] = None,
           meta: bool = False) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version). Otherwise the tensors must share one of ``dtypes``
    (float32 unless the kernel takes more), or, where ``each`` is given,
    tensor i must have one of ``each[i]``; they must be contiguous and lie
    on one CUDA device, or this raises: there is no fallback.

    Every kernel call passes here, so here too a call that autograd would
    have to differentiate (grad mode on, an input requiring grad) raises
    ``NotImplementedError``, on the CPU as on the card: a kernel writes
    its output through ctypes, with no ``grad_fn``, and a backward would
    stop there silently. ``matmul``, ``flash_attention`` and ``ssd_scan``
    have backward kernels and reach this only with grad mode off (inside
    their autograd Functions), as ``gmm_blocks`` and ``gmm_blocks_dw`` do
    inside the MoE layer's (``models.moe``).

    Where ``meta`` (a costed wrapper, which has a meta branch), tensors
    that all lie on ``meta`` (the dry run) are checked as CUDA tensors
    are, and this returns False: the wrapper then returns its outputs'
    shapes without a launch. Any other wrapper refuses meta tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{kernel}: no backward kernel yet, so no gradient flows through "
            f"it; call it under torch.no_grad() or on inputs that do not "
            f"require grad")
    devs = {t.device for t in ts}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type not in (
            ("cuda", "meta") if meta else ("cuda",)):
        where = ("on the CPU, on one CUDA device or on meta" if meta
                 else "on the CPU or on one CUDA device")
        raise ValueError(f"{kernel}: tensors must lie {where}, got "
                         f"{sorted(map(str, devs))}")
    if each is None:
        kinds = {t.dtype for t in ts}
        if len(kinds) != 1 or next(iter(kinds)) not in dtypes:
            raise TypeError(f"{kernel}: the CUDA kernel takes one dtype of "
                            f"{[str(d) for d in dtypes]}, got "
                            f"{sorted(map(str, kinds))}")
    else:
        for t, ok in zip(ts, each, strict=True):
            if t.dtype not in ok:
                raise TypeError(f"{kernel}: the CUDA kernel takes "
                                f"{[str(d) for d in ok]}, got {t.dtype}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: the CUDA kernel takes contiguous "
                             f"tensors")
    return False
