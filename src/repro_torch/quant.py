"""Per-channel weight quantization — the §3.1.2 transform taken one step
further: a cache entry that stores FEWER BYTES than the deployed precision.

Cold inference is I/O-bound, so the biggest lever on cold latency is bytes
read from disk. This module provides the numpy substrate for int8 / packed
int4 post-transform cache entries:

  * symmetric (and optionally asymmetric, int8 only) per-channel absmax
    quantization with a hard elementwise error bound of half a quantization
    step (``|w - dq(q(w))| <= scale/2`` per channel);
  * int4 nibble packing along axis 0 (rows 2i/2i+1 -> low/high nibble of one
    byte; odd row counts pad the final high nibble with the encoding of 0);
  * the *companion-key convention* quantized weight dicts use everywhere
    (kernels, the LayerStore, the super-bundle reader):

        {base}:q8      int8 data, the logical (K, N) shape
        {base}:q4      packed uint8 data, ((K+1)//2, N)
        {base}:qscale  float32 per-channel scales, keepdims shape (1, N)
        {base}:qzero   int32 per-channel zero points (asymmetric int8 only)

    Kernels emit and consume PLAIN numpy arrays under these names, so the
    profiler's scratch bundles, ``avatars_of``, the ProfileDB's JSON
    serialization and ``jax.ShapeDtypeStruct`` compile avatars all work
    unchanged — quantization never introduces a new array type;
  * fold/expand helpers for the super-bundle's format v4: on write, one
    companion group folds into ONE container extent (payload = the
    quantized bytes, CRC over exactly those bytes) whose header entry
    carries the scales/zero-points as metadata; on read, the extent
    expands back to the identical companion dict. ``docs/formats.md``
    has the byte-level spec.

The CUDA consumers (dequant-on-the-fly and fused dequant-matmul) live in
``repro_torch.kernels.quant``; this module stays numpy-only so the
checkpoint layer can import it without pulling in torch.
"""
from __future__ import annotations

import base64
from typing import Dict, List, Optional, Tuple

import numpy as np

Q8_SUFFIX = ":q8"
Q4_SUFFIX = ":q4"
SCALE_SUFFIX = ":qscale"
ZERO_SUFFIX = ":qzero"

# scheme tag (the folded extent's dtype tag) -> data-companion suffix
SCHEME_SUFFIX = {"int8": Q8_SUFFIX, "int4": Q4_SUFFIX}
_SUFFIX_SCHEME = {v: k for k, v in SCHEME_SUFFIX.items()}

# symmetric ranges: +/-127 and +/-7 (never -128/-8) keep |w - dq(q(w))|
# <= scale/2 without an asymmetric clipping tail
_QMAX = {"int8": 127, "int4": 7}


def payload_dtype(scheme: str) -> np.dtype:
    """Storage dtype of a folded extent's payload: int8 data is stored as
    int8; int4 data is nibble-packed into uint8 bytes."""
    if scheme == "int8":
        return np.dtype(np.int8)
    if scheme == "int4":
        return np.dtype(np.uint8)
    raise ValueError(f"unknown quantization scheme {scheme!r}")


def error_bound(scale: np.ndarray) -> np.ndarray:
    """Hard elementwise reconstruction bound: half a quantization step."""
    return 0.5 * np.abs(np.asarray(scale, np.float32))


# ---------------------------------------------------------------------------
# quantize / dequantize (numpy)
# ---------------------------------------------------------------------------
def _channel_scale(a: np.ndarray, axis: int, qmax: int) -> np.ndarray:
    absmax = np.max(np.abs(a), axis=axis, keepdims=True)
    s = absmax / float(qmax)
    # all-zero channels quantize to 0 exactly under any nonzero scale; 1.0
    # keeps dequantization well-defined without special-casing readers
    return np.where(s > 0, s, 1.0).astype(np.float32)


def quantize_int8(a: np.ndarray, *, axis: int = 0,
                  symmetric: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Per-channel int8 quantization of ``a`` along ``axis``. Returns
    ``(q, scale, zero)``; ``zero`` is None for symmetric. Guarantees
    ``|a - dequant| <= scale/2`` elementwise."""
    a = np.asarray(a, np.float32)
    if symmetric:
        s = _channel_scale(a, axis, _QMAX["int8"])
        q = np.clip(np.rint(a / s), -127, 127).astype(np.int8)
        return q, s, None
    lo = np.min(a, axis=axis, keepdims=True)
    hi = np.max(a, axis=axis, keepdims=True)
    s = ((hi - lo) / 254.0).astype(np.float32)
    s = np.where(s > 0, s, 1.0).astype(np.float32)
    # zero point placed so lo -> -127 and hi -> +127; the zero point enters
    # the arithmetic as an exact integer, so dq = (q - z) * s = rint(a/s)*s
    z = (-127 - np.rint(lo / s)).astype(np.int32)
    q = np.clip(np.rint(a / s) + z, -127, 127).astype(np.int8)
    return q, s, z


def quantize_int4(a: np.ndarray, *, axis: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int4 quantization of a 2-D array; returns
    ``(packed, scale)`` with ``packed`` uint8 of shape ``((K+1)//2, N)``.
    Values land in [-7, 7]; ``|a - dequant| <= scale/2`` elementwise."""
    a = np.asarray(a, np.float32)
    if a.ndim != 2:
        raise ValueError(f"int4 packing needs a 2-D array, got {a.shape}")
    s = _channel_scale(a, axis, _QMAX["int4"])
    q = np.clip(np.rint(a / s), -7, 7).astype(np.int8)
    return pack_int4(q), s


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int8 values in [-8, 7] two-per-byte along axis 0: row ``2i``
    into the low nibble, row ``2i+1`` into the high nibble. An odd row
    count pads the final high nibble with 0 (the encoding of 0)."""
    q = np.asarray(q, np.int8)
    K = q.shape[0]
    if K % 2:
        q = np.concatenate([q, np.zeros((1,) + q.shape[1:], np.int8)])
    lo = q[0::2].astype(np.uint8) & 0x0F
    hi = q[1::2].astype(np.uint8) & 0x0F
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`: ``((K+1)//2, ...)`` uint8 bytes back to
    ``(k, ...)`` int8 values (sign-extended nibbles)."""
    packed = np.asarray(packed, np.uint8)
    lo = (packed & 0x0F).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo).astype(np.int8)
    hi = np.where(hi >= 8, hi - 16, hi).astype(np.int8)
    out = np.empty((2 * packed.shape[0],) + packed.shape[1:], np.int8)
    out[0::2] = lo
    out[1::2] = hi
    return out[:k]


def quantize_weight(name: str, a: np.ndarray, *, bits: int = 8,
                    axis: int = 0, symmetric: bool = True
                    ) -> Dict[str, np.ndarray]:
    """One tensor -> its companion dict under the module's key convention."""
    if bits == 8:
        q, s, z = quantize_int8(a, axis=axis, symmetric=symmetric)
        out = {name + Q8_SUFFIX: q, name + SCALE_SUFFIX: s}
        if z is not None:
            out[name + ZERO_SUFFIX] = z
        return out
    if bits == 4:
        packed, s = quantize_int4(a, axis=axis)
        return {name + Q4_SUFFIX: packed, name + SCALE_SUFFIX: s}
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def dequantize_weight(companions: Dict[str, np.ndarray], base: str,
                      logical_shape: Optional[Tuple[int, ...]] = None
                      ) -> np.ndarray:
    """Reconstruct ``base`` (float32) from its companions. ``logical_shape``
    is required for int4 (the packed payload cannot recover an odd K)."""
    s = np.asarray(companions[base + SCALE_SUFFIX], np.float32)
    if base + Q8_SUFFIX in companions:
        q = np.asarray(companions[base + Q8_SUFFIX], np.float32)
        z = companions.get(base + ZERO_SUFFIX)
        if z is not None:
            q = q - np.asarray(z, np.float32)  # dq = (q - z) * s
        return q * s
    packed = companions[base + Q4_SUFFIX]
    if logical_shape is None:
        raise ValueError(f"{base}: int4 dequantization needs logical_shape")
    q = unpack_int4(packed, logical_shape[0]).astype(np.float32)
    return q * s


def quantize_weights(raw: Dict[str, np.ndarray], *, bits: int = 8,
                     axis: int = 0, min_size: int = 16
                     ) -> Dict[str, np.ndarray]:
    """Kernel-transform helper: quantize every 2-D float tensor of a raw
    weight dict (the matmul operands), pass everything else — biases,
    norms, already-integer tensors — through unchanged."""
    from repro_torch.bf16 import is_bf16

    out: Dict[str, np.ndarray] = {}
    for name, v in raw.items():
        a = np.asarray(v)
        floaty = a.dtype.kind == "f" or is_bf16(a)
        if a.ndim == 2 and a.size >= min_size and floaty:
            out.update(quantize_weight(name, np.asarray(a, np.float32),
                                       bits=bits, axis=axis))
        else:
            out[name] = a
    return out


# ---------------------------------------------------------------------------
# companion-group detection + fold/expand (the super-bundle v4 hooks)
# ---------------------------------------------------------------------------
def split_groups(weights: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, dict], Dict[str, np.ndarray]]:
    """Partition a weight dict into quantized companion groups and plain
    tensors. Returns ``(groups, rest)``: ``groups[base]`` is
    ``{"scheme", "data", "scale", "zero"(opt)}``. A ``:q8``/``:q4`` key
    without its ``:qscale`` companion stays a plain tensor."""
    groups: Dict[str, dict] = {}
    consumed: set = set()
    for name in weights:
        for suf, scheme in _SUFFIX_SCHEME.items():
            if not name.endswith(suf):
                continue
            base = name[: -len(suf)]
            if base + SCALE_SUFFIX not in weights:
                continue
            g = {"scheme": scheme, "data": np.asarray(weights[name]),
                 "scale": np.asarray(weights[base + SCALE_SUFFIX])}
            consumed.update((name, base + SCALE_SUFFIX))
            if base + ZERO_SUFFIX in weights:
                g["zero"] = np.asarray(weights[base + ZERO_SUFFIX])
                consumed.add(base + ZERO_SUFFIX)
            groups[base] = g
    rest = {n: v for n, v in weights.items() if n not in consumed}
    return groups, rest


def _arr_to_json(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def _arr_from_json(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]),
                      dtype=np.dtype(d["dtype"])).reshape(d["shape"])
    a.flags.writeable = False
    return a


def quant_meta(group: dict) -> dict:
    """Header-JSON quantization metadata for one folded extent: the scheme
    plus the (small) per-channel scale/zero-point arrays inline — the
    payload carries ONLY the quantized bytes, so its CRC covers exactly
    them."""
    meta = {"scheme": group["scheme"], "scale": _arr_to_json(group["scale"])}
    if group.get("zero") is not None:
        meta["zero"] = _arr_to_json(group["zero"])
    return meta


def expand_entry(name: str, meta: dict, payload: np.ndarray,
                 *, materialize: bool = False) -> Dict[str, np.ndarray]:
    """A folded extent back to its companion dict: the payload view under
    the data key, scales (and zero points) decoded from the header
    metadata. Exact inverse of ``split_groups`` + ``quant_meta`` — a
    fold/expand round-trip is bit-identical."""
    suf = SCHEME_SUFFIX[meta["scheme"]]
    out = {name + suf: np.array(payload) if materialize else payload,
           name + SCALE_SUFFIX: _arr_from_json(meta["scale"])}
    if "zero" in meta:
        out[name + ZERO_SUFFIX] = _arr_from_json(meta["zero"])
    return out


def is_quantized(weights: Dict[str, np.ndarray]) -> bool:
    groups, _rest = split_groups(weights)
    return bool(groups)


def logical_nbytes(weights: Dict[str, np.ndarray]) -> int:
    """float32 bytes of the dequantized view of a (possibly quantized)
    weight dict — the synthetic profiler's dequant-cost denominator."""
    groups, rest = split_groups(weights)
    n = sum(int(np.asarray(v).nbytes) for v in rest.values())
    for g in groups.values():
        elems = int(np.asarray(g["data"]).size)
        if g["scheme"] == "int4":
            elems *= 2
        n += 4 * elems
    return n
