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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("matmul", "conv_winograd")   # csrc/<name>.cu -> one library each
HEADERS = ("gemm_f32.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "repro_matmul_f32": [_P, _P, _P, _I, _I, _I, _P],
    "repro_matmul_packed_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_winograd_tile_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
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


def on_cpu(kernel: str, *ts) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version). Otherwise the tensors must be float32, contiguous and
    on one CUDA device, or this raises: there is no fallback."""
    devs = {t.device for t in ts}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{kernel}: tensors must lie on the CPU or on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: the CUDA kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: the CUDA kernel takes contiguous "
                             f"tensors")
    return False
