"""Public kernel entry points of the port — the counterpart of
``repro/kernels/ops.py``.

Dispatch is by the tensors' device: a CUDA tensor launches the
hand-written Hopper kernel (``repro_torch/csrc``), a CPU tensor takes the
kernel's plain PyTorch version (the analogue of Pallas ``interpret=True``
in the JAX package). The registry kernels' ``execute`` bodies call these.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import attention as _attn
from repro_torch.kernels import conv_winograd as _wino
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ssd as _ssd

matmul = _mm.matmul
matmul_packed = _mm.matmul_packed
winograd_tile_matmul = _wino.winograd_tile_matmul
flash_attention = _attn.flash_attention
flash_attention_bwd = _attn.flash_attention_bwd
decode_attention = _attn.decode_attention
dequant_int8 = _quant.dequant_int8
dequant_int4 = _quant.dequant_int4
matmul_dequant_int8 = _quant.matmul_dequant_int8
matmul_dequant_int4 = _quant.matmul_dequant_int4
gmm_blocks = _gmm.gmm_blocks
gmm_blocks_dw = _gmm.gmm_blocks_dw
ssd_scan = _ssd.ssd_scan
ssd_scan_bwd = _ssd.ssd_scan_bwd

# launch-count name -> (CUDA source, TPU kernel it replaces); ``matmul``
# counts the f32 launches of the one wrapper, ``matmul_bf16`` its bf16 ones
# (bf16 or f32 out)
KERNELS = {
    "matmul": ("src/repro_torch/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:37"),
    "matmul_bf16": ("src/repro_torch/csrc/matmul.cu",
                    "src/repro/kernels/matmul.py:37"),
    "matmul_packed": ("src/repro_torch/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:81"),
    "winograd_tile_matmul": ("src/repro_torch/csrc/conv_winograd.cu",
                             "src/repro/kernels/conv_winograd.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:75"),
    # no Pallas kernel: the reference differentiates its jnp attention
    # (jax.grad of flash_attention_ref)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "none (the reference differentiates jnp "
                            "attention: jax.grad of "
                            "src/repro/kernels/ref.py:22)"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/attention.py:163"),
    "dequant_int8": ("src/repro_torch/csrc/quant.cu",
                     "src/repro/kernels/quant.py:55"),
    "dequant_int4": ("src/repro_torch/csrc/quant.cu",
                     "src/repro/kernels/quant.py:84"),
    "matmul_dequant_int8": ("src/repro_torch/csrc/quant.cu",
                            "src/repro/kernels/quant.py:131"),
    "matmul_dequant_int4": ("src/repro_torch/csrc/quant.cu",
                            "src/repro/kernels/quant.py:179"),
    "gmm_blocks": ("src/repro_torch/csrc/gmm.cu",
                   "src/repro/kernels/gmm.py:36"),
    # no Pallas kernel: the reference's custom VJP computes dw with jnp
    "gmm_blocks_dw": ("src/repro_torch/csrc/gmm_dw.cu",
                      "none (the reference's custom VJP computes dw with "
                      "jnp: src/repro/models/moe.py:163)"),
    "ssd_scan": ("src/repro_torch/csrc/ssd.cu",
                 "src/repro/kernels/ssd.py:64"),
    # no Pallas kernel: the reference differentiates its jnp scan
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                     "none (the reference differentiates jnp ssd_chunked: "
                     "jax.grad of src/repro/models/ssm.py:36)"),
}

_COUNTERS = (_mm.launches, _wino.launches, _attn.launches, _quant.launches,
             _gmm.launches, _ssd.launches)
# each counter with the lock its wrappers bump it under
_LOCKED = tuple(zip(_COUNTERS, (_mm._lock, _wino._lock, _attn._lock,
                                _quant._lock, _gmm._lock, _ssd._lock)))


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS + (_mm.gemm_paths,):
        for k in c:
            c[k] = 0


def add_launch_counts(launches: Dict[str, int],
                      paths: Optional[Dict[str, int]] = None) -> None:
    """Add ``launches`` (``launch_counts()`` keys) and ``paths``
    (``gemm_path_counts()`` keys) to the counters; a count may be
    negative. A CUDA graph's replay launches its kernels without calling
    the wrappers, so its owner adds the counts of its capture here at
    every replay."""
    for c, lock in _LOCKED:
        with lock:
            for k in c:
                c[k] += launches.get(k, 0)
    with _mm._lock:
        for k, n in (paths or {}).items():
            _mm.gemm_paths[k] += n


def gemm_path_counts() -> Dict[str, int]:
    """Launches of the bf16 tensor-core kernels (``matmul``,
    ``gmm_blocks`` and ``gmm_blocks_dw``) by path: tile, skinny, tma
    (``gmm_blocks_dw``'s TMA + ``wgmma`` kernel), and those that split
    K."""
    return dict(_mm.gemm_paths)
