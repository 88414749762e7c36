"""Packed per-layer weight bundles — the cold path's on-disk format.

MNN-style pre-arranged single-blob layouts: all tensors of one layer live in
ONE file so a cold read is one ``open`` + one (m)mapped scan instead of N
opens + N copies. Layout::

    [0:4)    magic  b"NNVB"
    [4:8)    format version (uint32 LE)
    [8:16)   header length in bytes (uint64 LE)
    [16:16+H) header — UTF-8 JSON:
              {"tensors": [{"name", "dtype", "shape", "offset", "nbytes"}]}
    ...      zero padding to the first 64-byte boundary
    segments tensor payloads, each starting on a 64-byte boundary
             (``offset`` is absolute from the start of the file)

Dtypes are tagged by name ("float32", "bfloat16", "int8", ...); bfloat16 is
stored natively — the payload *is* the bf16 bits, no ``.bf16.npy``
uint16-view hack — and read back as the port's ``bf16.BFLOAT16`` (uint16
bit patterns under the "bfloat16" tag; no ``ml_dtypes``).

Reads come in two flavors:

  * ``read_bundle(path)`` — one sequential read, arrays own their memory;
  * ``read_bundle(path, mmap=True)`` — zero-copy: every tensor is a
    read-only view into a single ``np.memmap``. No payload bytes are
    touched until a consumer (transform / device staging) faults them in,
    which is exactly what the pipelined runtime wants: the 'read' op
    becomes metadata-only and the cost surfaces inside transform/stage,
    off the critical exec chain. The views are immutable (writes raise) —
    safe to hand to kernels, which copy on transform anyway.

The 64-byte segment alignment keeps every view aligned for any dtype and
matches cache-line/DMA-friendly boundaries.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np

from repro_torch import bf16

MAGIC = b"NNVB"
VERSION = 1
ALIGN = 64
_HEADER_FMT = "<4sIQ"  # magic, version, header-json length
_HEADER_FIXED = struct.calcsize(_HEADER_FMT)


def _dtype_from_tag(tag: str) -> np.dtype:
    return bf16.np_dtype(tag)


def _dtype_tag(dt: np.dtype) -> str:
    if bf16.is_bf16(np.dtype(dt)):
        return "bfloat16"
    return dt.name if hasattr(dt, "name") else str(dt)


def _pad_to(n: int, align: int = ALIGN) -> int:
    return (n + align - 1) // align * align


def atomic_write(path: Path, write_fn, *, durable: bool = False) -> None:
    """Publish a file atomically: ``write_fn(f)`` streams into ``<path>.tmp``,
    which is renamed over ``path`` only on success — readers never see a torn
    file, and a failed write never leaves the ``.tmp`` behind. With
    ``durable`` the tmp is fsynced before the rename and the directory
    after it, so the publish also survives power loss (the ordering the
    super-bundle's journaled commits rely on)."""
    from repro_torch.checkpoint.integrity import fsync_dir, fsync_file

    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            if durable:
                fsync_file(f)
        tmp.replace(path)
        if durable:
            fsync_dir(path.parent)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def write_bundle(path: Path, weights: Dict[str, np.ndarray]) -> int:
    """Write all tensors of one layer as a single packed bundle file.
    Returns the total file size in bytes."""
    path = Path(path)
    entries: List[dict] = []
    arrs: List[np.ndarray] = []
    # lay out segments first so the header can carry absolute offsets
    for name in sorted(weights):
        a = np.ascontiguousarray(np.asarray(weights[name]))
        entries.append({
            "name": name,
            "dtype": _dtype_tag(a.dtype),
            "shape": list(a.shape),
            "nbytes": int(a.nbytes),
        })
        arrs.append(a)
    header = {"tensors": entries}
    # offsets depend on the header length, which depends on the offsets'
    # digit count — fixed-point iterate (converges in <=3 rounds; offsets
    # only ever grow, so this terminates)
    for _ in range(8):
        hdr_bytes = json.dumps(header, separators=(",", ":")).encode()
        off = _pad_to(_HEADER_FIXED + len(hdr_bytes))
        changed = False
        for e in entries:
            if e.get("offset") != off:
                e["offset"] = off
                changed = True
            off = _pad_to(off + e["nbytes"])
        if not changed:
            break
    else:  # never: guards against writing a header with stale offsets
        raise RuntimeError(f"bundle header layout did not converge: {path}")
    total = off

    def _emit(f):
        f.write(struct.pack(_HEADER_FMT, MAGIC, VERSION, len(hdr_bytes)))
        f.write(hdr_bytes)
        for e, a in zip(entries, arrs):
            f.write(b"\0" * (e["offset"] - f.tell()))
            f.write(a.tobytes())
        f.write(b"\0" * (total - f.tell()))

    atomic_write(path, _emit)
    return total


def read_header(path: Path) -> dict:
    with open(path, "rb") as f:
        magic, version, hlen = struct.unpack(
            _HEADER_FMT, f.read(_HEADER_FIXED))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a bundle (magic={magic!r})")
        if version > VERSION:
            raise ValueError(f"{path}: bundle version {version} > {VERSION}")
        return json.loads(f.read(hlen).decode())


def _parse_header_from(buf) -> dict:
    magic, version, hlen = struct.unpack_from(_HEADER_FMT, buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not a bundle (magic={magic!r})")
    if version > VERSION:
        raise ValueError(f"bundle version {version} > {VERSION}")
    return json.loads(bytes(buf[_HEADER_FIXED:_HEADER_FIXED + hlen]).decode())


def read_bundle(path: Path, *, mmap: bool = False) -> Dict[str, np.ndarray]:
    """ONE open per layer — the header is parsed out of the same buffer the
    payload views come from, no separate metadata read. With ``mmap`` the
    returned arrays are read-only zero-copy views into a shared memory map
    (payload pages fault in lazily); otherwise one ``readinto`` materializes
    everything into a single writable buffer the views share."""
    import mmap as mmap_mod

    path = Path(path)
    with open(path, "rb") as f:
        if mmap:
            # mmap.mmap + frombuffer: ~2x cheaper to construct than
            # np.memmap, and read-only (ACCESS_READ) so views are immutable
            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
            buf = np.frombuffer(mm, dtype=np.uint8)
        else:
            size = path.stat().st_size
            buf = np.empty(size, np.uint8)
            f.readinto(memoryview(buf))  # one sequential read for the layer
    out: Dict[str, np.ndarray] = {}
    for e in _parse_header_from(buf)["tensors"]:
        seg = buf[e["offset"]: e["offset"] + e["nbytes"]]
        out[e["name"]] = seg.view(_dtype_from_tag(e["dtype"])).reshape(
            e["shape"])
    return out


def bundle_nbytes(path: Path) -> int:
    """Payload bytes (sum of tensor segments), excluding header/padding —
    the number the storage accounting compares against raw weight sizes."""
    return sum(e["nbytes"] for e in read_header(Path(path))["tensors"])
