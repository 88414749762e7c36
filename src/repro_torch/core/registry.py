"""Operator/kernel registry — §3.1.1 "one operator, many kernels".

A *kernel* is one concrete implementation of an operator, with its own
weights-transformation stage. Mirroring ncnn's 28 conv kernels, each operator
type registers several kernels with different (transform cost, execution
cost, transformed size) trade-offs; the scheduler picks per layer.

Kernels expose:
  transform(raw)        raw weight dict -> execution-format weight dict
  execute(w, x)         torch forward on NHWC tensors
  supports(spec)        static applicability predicate

``LayerSpec``, ``_canon``, the shape-class keys and every ``transform`` are
byte-identical numpy copies of the JAX package's (``_canon`` hashes type
names, so the class names stay too): ProfileDBs, ``plan.json`` and cache
entries read across the two packages. ``execute`` is torch; the GEMMs go
through the hand-written kernels of ``repro_torch.kernels.ops``
(``LinearDirect``/``ConvIm2col`` -> ``matmul``, ``LinearPacked`` ->
``matmul_packed``, ``ConvWinograd`` -> ``winograd_tile_matmul``).
``ConvDirect`` stays a library convolution (``lax.conv`` in the reference,
not a Pallas kernel), run with cuDNN's TF32 off. The lossy linear kernels
(bf16/int8/int4) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class OpKind(enum.Enum):
    READ = "read"
    TRANSFORM = "transform"
    STAGE = "stage"      # host -> device weight transfer
    EXECUTE = "execute"
    COMPILE = "compile"  # GPU-analogue stage: kernel build ("shader" cache)


@dataclass(frozen=True)
class LayerSpec:
    """One schedulable unit of the model (a layer, in the paper's terms)."""
    name: str
    op_type: str                  # 'conv2d' | 'linear' | 'stateless' | ...
    config: Dict[str, Any] = field(default_factory=dict)
    # weight name -> shape; empty for stateless units (e.g. attention core)
    weight_shapes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    @property
    def weight_bytes(self) -> int:
        return sum(4 * math.prod(s) for s in self.weight_shapes.values())


@dataclass(frozen=True)
class Operation:
    """One stage of one layer's kernel — the scheduler's unit of work."""
    layer: str
    kind: OpKind
    index: int  # layer index in the chain


# ---------------------------------------------------------------------------
# shape classes — profile/compile equivalence between layers
# ---------------------------------------------------------------------------
def _canon(v: Any) -> Any:
    """Deterministic, JSON-stable canonicalization of config values."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return [[str(k), _canon(v[k])] for k in sorted(v, key=str)]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return [type(v).__name__, _canon(dataclasses.asdict(v))]
    if isinstance(v, np.dtype):
        return str(v)
    return repr(v)


def shape_class_key(
    spec: LayerSpec,
    *,
    input_shape: Optional[Tuple[int, ...]] = None,
    input_dtype: Optional[str] = None,
    weight_dtypes: Optional[Dict[str, str]] = None,
) -> str:
    """Canonical shape-class identity of a layer: two layers with the same
    key are interchangeable for profiling and compilation — same op_type,
    same weight shapes/dtypes, same kernel-relevant config, and (when
    given) same input avatar. Byte-identical decoder blocks of an LLM graph
    all land in one class, so ``decide()`` profiles/compiles ONE
    representative and fans the result out.

    Stateless units wrap arbitrary Python callables whose identity the spec
    cannot see, so they never share: their key includes the layer name.
    """
    if spec.op_type == "stateless":
        payload: List[Any] = ["stateless", spec.name]
    else:
        payload = [
            spec.op_type,
            [[k, list(spec.weight_shapes[k])] for k in sorted(spec.weight_shapes)],
            _canon(spec.config),
        ]
    payload.append([
        list(input_shape) if input_shape is not None else None,
        input_dtype,
        _canon(weight_dtypes) if weight_dtypes else None,
    ])
    blob = json.dumps(payload, sort_keys=False, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def shape_class_sibling_key(
    spec: LayerSpec,
    *,
    input_shape: Optional[Tuple[int, ...]] = None,
    input_dtype: Optional[str] = None,
    weight_dtypes: Optional[Dict[str, str]] = None,
) -> Optional[str]:
    """Batch-agnostic relative of :func:`shape_class_key`: the leading
    (batch) dim of the input avatar is replaced by a sentinel, so classes
    identical up to batch size share one sibling key. The ProfileDB uses it
    for *approximate* profile fan-out (``approx=True``): a layer profiled
    at batch 1 seeds the candidate costs for the same layer at batch 4 —
    per-element op costs barely shift with batch on these graphs, and a
    stale estimate only mis-ranks candidates, never breaks correctness.

    ``None`` when there is no input avatar to widen (nothing to
    approximate over) or for stateless units (never shared)."""
    if spec.op_type == "stateless" or input_shape is None or not input_shape:
        return None
    payload: List[Any] = [
        spec.op_type,
        [[k, list(spec.weight_shapes[k])] for k in sorted(spec.weight_shapes)],
        _canon(spec.config),
    ]
    payload.append([
        ["B"] + list(input_shape[1:]),
        input_dtype,
        _canon(weight_dtypes) if weight_dtypes else None,
    ])
    blob = json.dumps(payload, sort_keys=False, separators=(",", ":"))
    return "~" + hashlib.sha1(blob.encode()).hexdigest()[:20]


class Kernel:
    name: str = "base"
    op_type: str = "generic"

    def supports(self, spec: LayerSpec) -> bool:
        return True

    def transform(self, raw: Dict[str, np.ndarray], spec: LayerSpec) -> Dict[str, np.ndarray]:
        """Raw -> execution-ready weights. Runs on host (little cores)."""
        return raw

    def execute(self, w: Dict[str, torch.Tensor], x: torch.Tensor, spec: LayerSpec) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return f"<Kernel {self.op_type}/{self.name}>"


# ---------------------------------------------------------------------------
# linear kernels
# ---------------------------------------------------------------------------
class LinearDirect(Kernel):
    """Plain x @ W — zero transform (the paper's '3x3s1'/'general' analogue)."""
    name = "direct"
    op_type = "linear"

    def execute(self, w, x, spec):
        W = w["w"]
        lead = x.shape[:-1]
        y = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), W)
        y = y.reshape(*lead, W.shape[1])
        if "b" in w:
            y = y + w["b"]
        return y


class LinearPacked(Kernel):
    """Block-tiled layout: W (K,N) -> (N/bn, K/bk, bk, bn), padded to
    multiples of 128. Executes on the packed GEMM kernel
    (repro_torch.kernels.matmul.matmul_packed), which reads one contiguous
    weight tile per K step; the packing pass is a real transformation cost
    — the sgemm_pack4 analogue."""
    name = "packed"
    op_type = "linear"
    bk = 128
    bn = 128

    def transform(self, raw, spec):
        w = raw["w"]
        K, N = w.shape
        bk, bn = self.bk, self.bn
        Kp = (K + bk - 1) // bk * bk
        Np = (N + bn - 1) // bn * bn
        wp = np.zeros((Kp, Np), w.dtype)
        wp[:K, :N] = w
        packed = np.ascontiguousarray(
            wp.reshape(Kp // bk, bk, Np // bn, bn).transpose(2, 0, 1, 3)
        )
        out = {"w_packed": packed, "orig_kn": np.array([K, N], np.int64)}
        if "b" in raw:
            out["b"] = raw["b"]
        return out

    def execute(self, w, x, spec):
        packed = w["w_packed"]  # (nN, nK, bk, bn)
        K, N = spec.config["in_features"], spec.config["out_features"]
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).contiguous()
        # blocked contraction consuming the packed layout directly; the
        # kernel masks K up to the packed tile edge (no padded copy of x)
        y = ops.matmul_packed(xf, packed, K, N)
        if "b" in w:
            y = y + w["b"]
        return y.reshape(*lead, N)


# ---------------------------------------------------------------------------
# conv2d kernels (NHWC, filters OIHW in raw checkpoints — ncnn-style)
# ---------------------------------------------------------------------------
def _conv_dims(spec):
    c = spec.config
    return c["kernel"], c.get("stride", 1), c.get("padding", "SAME")


def _same_pads(size: int, k: int, s: int, padding: str) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim, as XLA computes it:
    ``SAME`` pads ``total // 2`` before and the rest after (asymmetric for
    even sizes at stride 2, unlike ``F.conv2d(padding=1)``)."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"unsupported conv padding {padding!r}")
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, k: int, s: int, padding: str) -> torch.Tensor:
    ph = _same_pads(x.shape[1], k, s, padding)
    pw = _same_pads(x.shape[2], k, s, padding)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


class ConvDirect(Kernel):
    """Library convolution on raw OIHW filters — zero transform. The
    reference's ``lax.conv_general_dilated``; cuDNN runs it with TF32 off,
    and the SAME padding is applied explicitly (XLA's asymmetric split)."""
    name = "direct"
    op_type = "conv2d"

    def execute(self, w, x, spec):
        k, s, p = _conv_dims(spec)
        xp = _pad_nhwc(x, k, s, p).permute(0, 3, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv2d(xp, w["w"], stride=s)
        y = y.permute(0, 2, 3, 1).contiguous()
        if "b" in w:
            y = y + w["b"]
        return y


class ConvIm2col(Kernel):
    """im2col + sgemm: filters reshaped (O,I,kh,kw) -> (I*kh*kw, O). Cheap
    transform, fast-ish exec (the paper's sgemm kernels)."""
    name = "im2col_sgemm"
    op_type = "conv2d"

    def transform(self, raw, spec):
        w = raw["w"]  # (O, I, kh, kw)
        O, I, kh, kw = w.shape
        wt = np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(kh * kw * I, O))
        out = {"w_mat": wt}
        if "b" in raw:
            out["b"] = raw["b"]
        return out

    def execute(self, w, x, spec):
        k, s, p = _conv_dims(spec)
        N, C = x.shape[0], x.shape[-1]
        xp = _pad_nhwc(x, k, s, p)
        # (N, Ho, Wo, C, kh, kw) windows; features reordered (kh, kw, C) to
        # match w_mat's (kh*kw*I, O) rows
        patches = xp.unfold(1, k, s).unfold(2, k, s)
        Ho, Wo = patches.shape[1], patches.shape[2]
        pm = patches.permute(0, 1, 2, 4, 5, 3).reshape(N * Ho * Wo, k * k * C)
        y = ops.matmul(pm.contiguous(), w["w_mat"])
        y = y.reshape(N, Ho, Wo, -1)
        if "b" in w:
            y = y + w["b"]
        return y


class ConvWinograd(Kernel):
    """Winograd F(2x2, 3x3): filter transform (O,I,3,3) -> (16, I, O) done
    offline/on little cores (the paper's flagship heavy transform, Fig. 3);
    execution is 16 batched (I,O) matmuls over 4x4 input tiles, on the
    tile-GEMM kernel (repro_torch.kernels.conv_winograd); the input and
    output tile transforms are torch ops."""
    name = "winograd_f2x3"
    op_type = "conv2d"

    G = np.array(
        [[1.0, 0.0, 0.0],
         [0.5, 0.5, 0.5],
         [0.5, -0.5, 0.5],
         [0.0, 0.0, 1.0]], np.float32)
    Bt = np.array(
        [[1, 0, -1, 0],
         [0, 1, 1, 0],
         [0, -1, 1, 0],
         [0, 1, 0, -1]], np.float32)
    At = np.array(
        [[1, 1, 1, 0],
         [0, 1, -1, -1]], np.float32)

    def __init__(self):
        self._dev_consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _consts(self, device: torch.device):
        c = self._dev_consts.get(device)
        if c is None:
            c = self._dev_consts[device] = (
                torch.as_tensor(self.Bt, device=device),
                torch.as_tensor(self.At, device=device))
        return c

    def supports(self, spec):
        k, s, _ = _conv_dims(spec)
        return k == 3 and s == 1

    def transform(self, raw, spec):
        w = raw["w"]  # (O, I, 3, 3)
        O, I, _, _ = w.shape
        # U = G g G^T per (O, I): g (O,I,3,3) -> (O,I,4,4)
        U = np.einsum("ab,oibc,dc->oiad", self.G, w, self.G, optimize=True)
        Ut = np.ascontiguousarray(U.transpose(2, 3, 1, 0).reshape(16, I, O))
        out = {"w_wino": Ut}
        if "b" in raw:
            out["b"] = raw["b"]
        return out

    def execute(self, w, x, spec):
        U = w["w_wino"]  # (16, I, O)
        N, H, W_, C = x.shape
        pad_h = (-H) % 2 + 1
        pad_w = (-W_) % 2 + 1
        xp = F.pad(x, (0, 0, 1, pad_w, 1, pad_h))
        # overlapping 4x4 tiles with stride 2: (N, nth, ntw, C, 4, 4)
        tiles = xp.unfold(1, 4, 2).unfold(2, 4, 2)
        nth, ntw = tiles.shape[1], tiles.shape[2]
        tiles = tiles.permute(0, 1, 2, 4, 5, 3)     # (N, nth, ntw, 4, 4, C)
        Bt, At = self._consts(x.device)
        V = torch.einsum("ab,nhwbcq,dc->nhwadq", Bt, tiles, Bt)  # (N,h,w,4,4,C)
        V = V.reshape(N * nth * ntw, 16, C).transpose(0, 1).contiguous()
        M = ops.winograd_tile_matmul(V, U)                       # (16, T, O)
        O_ = M.shape[-1]
        M = M.transpose(0, 1).reshape(N, nth, ntw, 4, 4, O_)
        Y = torch.einsum("ab,nhwbcq,dc->nhwadq", At, M, At)     # (N,h,w,2,2,O)
        Y = Y.permute(0, 1, 3, 2, 4, 5).reshape(N, nth * 2, ntw * 2, O_)
        Y = Y[:, :H, :W_, :].contiguous()
        if "b" in w:
            Y = Y + w["b"]
        return Y


# ---------------------------------------------------------------------------
# stateless units (attention core, pooling, activations…): execute only
# ---------------------------------------------------------------------------
class StatelessKernel(Kernel):
    name = "fn"
    op_type = "stateless"

    def __init__(self, fn: Callable, name: str = "fn"):
        self.fn = fn
        self.name = name

    def execute(self, w, x, spec):
        return self.fn(x)


KERNEL_REGISTRY: Dict[str, List[Kernel]] = {
    "linear": [LinearDirect(), LinearPacked()],
    "conv2d": [ConvDirect(), ConvIm2col(), ConvWinograd()],
}

def registry_for(op_type: str, *, allow_lossy: bool = False) -> List[Kernel]:
    if allow_lossy:
        raise NotImplementedError(
            "the lossy linear kernels (bf16/int8/int4) are not ported yet")
    return list(KERNEL_REGISTRY.get(op_type, []))
