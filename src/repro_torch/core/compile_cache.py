"""Executable ("shader") cache — §3.4 on a CUDA card.

On GPU the paper caches compiled SPIR-V shaders to skip shader compilation
in cold inference. Here the compiled artefacts are the kernel libraries
that ``repro_torch.kernels._native`` builds with ``nvcc`` (one ``.so`` per
CUDA source, named by a digest of its sources and flags, so it is reused
across processes until a source changes). PyTorch runs eagerly, so what
the cache holds per key is the bound execute closure. A first use of a key
on a CUDA device makes sure the kernel libraries are loaded: when ``nvcc``
had to build one, the key counts as a miss (``compile_s``); when the
libraries were already on disk or loaded, as a disk hit (``deserialize_s``).
On the CPU there is nothing to build and every first use is a miss.

Keys are (kernel, *shape-class*, example shapes, torch/CUDA version, SM
arch) — the same sharing identity as the JAX package's XLA cache: layers
of one shape class share one entry. Examples may be real tensors or
meta-tensor avatars; no weight bytes are needed.
"""
from __future__ import annotations

import functools
import hashlib
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import bf16
from repro_torch.device import as_device


@functools.lru_cache(maxsize=1)
def _version_tag() -> str:
    """torch/CUDA versions and the card's SM arch — constant per process,
    probed once. Also feeds ``profiler.host_fingerprint``."""
    arch = "cpu"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        arch = f"sm_{major}{minor}"
    return f"torch {torch.__version__}/cuda {torch.version.cuda}/{arch}"


def _key(kernel_name: str, ident: str, shapes: Tuple, version: str) -> str:
    h = hashlib.sha1(repr((kernel_name, ident, shapes, version)).encode())
    return h.hexdigest()[:24]


class CompileCache:
    def __init__(self, device="cuda"):
        self.device = as_device(device)
        self.mem: Dict[str, Callable] = {}
        self.stats = {"hits": 0, "misses": 0, "disk_hits": 0,
                      "compile_s": 0.0, "deserialize_s": 0.0}

    def get(self, kernel_name: str, spec, fn: Callable, w_example, x_example,
            *, shape_class: Optional[str] = None):
        """Returns the execute callable for fn(w, x). ``shape_class`` is the
        sharing identity — all layers of one class get the same entry;
        without it the cache degrades to per-spec keying."""
        shapes = (
            tuple(sorted((k, tuple(v.shape), _dtype_name(v.dtype))
                         for k, v in w_example.items())),
            (tuple(x_example.shape), _dtype_name(x_example.dtype)),
        )
        ident = shape_class if shape_class is not None else spec.name
        key = _key(kernel_name, ident, shapes, _version_tag())
        if key in self.mem:
            self.stats["hits"] += 1
            return self.mem[key]
        t0 = time.perf_counter()
        built = True
        if self.device.type == "cuda":
            from repro_torch.kernels import _native

            before = _native.stats["built"]
            _native.load_all()
            built = _native.stats["built"] > before
        dt = time.perf_counter() - t0
        if built:
            self.stats["compile_s"] += dt
            self.stats["misses"] += 1
        else:
            self.stats["deserialize_s"] += dt
            self.stats["disk_hits"] += 1
        self.mem[key] = fn
        return fn


def _dtype_name(dt: Any) -> str:
    """numpy-style dtype name ("float32", "bfloat16") for torch and numpy
    dtypes; a bf16 avatar keys as "bfloat16" in either form."""
    return bf16.dtype_name(dt)
