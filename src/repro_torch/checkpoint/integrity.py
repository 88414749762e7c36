"""Integrity primitives shared by the on-disk containers.

Two facilities, both dependency-free (stdlib + numpy):

  * ``crc32c`` — the Castagnoli CRC (poly 0x1EDC6F41, reflected), the
    checksum the super-bundle v3 format stores per extent entry and per
    journal record. When a C-backed implementation is importable
    (``google_crc32c``, which uses SSE4.2/ARMv8 CRC instructions where
    available, or the ``crc32c`` package) it is used for the payload work
    — the ~100 MB/s software path makes an eager fsck of a GB-scale model
    noticeably slow. NOTE: stdlib ``zlib.crc32`` is the *wrong
    polynomial* (CRC-32/ISO-HDLC, 0x04C11DB7) and can never back this
    function. The numpy software implementation remains the always-
    available fallback (and the cross-check oracle for the fast paths):
    pure Python CRC loops run at ~2 MB/s, far too slow to checksum weight
    payloads, so it exploits the GF(2) linearity of CRCs: the
    contribution of byte ``b`` at distance ``d`` from the end of a block
    is a pure table lookup ``PT[d][b]``, which lets whole blocks be
    reduced with one vectorized numpy gather + XOR instead of a byte
    loop. Blocks are then folded left-to-right with a precomputed
    advance-by-block-of-zeros operator. The one-time table build (~1 MB)
    is lazy. ``REPRO_CRC32C=software`` forces the fallback.

  * fsync-ordered durable writes — ``fsync_file``/``fsync_dir`` plus
    ``atomic_write_text``, the commit primitive for small JSON sidecars
    (plan, fingerprints, profile DB): write to ``.tmp``, fsync, rename,
    fsync the directory, so a crash never leaves a torn sidecar and a
    published one survives power loss. The container writers use the same
    helpers through ``bundle.atomic_write(durable=True)``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_CHUNK = 1024       # block size of the vectorized reduction
_MASK = 0xFFFFFFFF

_TABLE: Optional[np.ndarray] = None      # (256,) uint32 byte table
_TABLE_LIST: Optional[List[int]] = None  # same, as a Python list (tail loop)
_PT: Optional[np.ndarray] = None         # (CHUNK, 256): PT[d] = advance^d(table)
_PT_REV: Optional[np.ndarray] = None     # PT[::-1], gather layout
_ADV: Optional[List[List[int]]] = None   # advance state by CHUNK zero bytes


def _build_tables():
    global _TABLE, _TABLE_LIST, _PT, _PT_REV, _ADV
    x = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        x = np.where(x & 1, (x >> 1) ^ np.uint32(_POLY), x >> 1)
    _TABLE = x
    _TABLE_LIST = x.tolist()
    # PT[d][v] = state contribution of table[v] advanced by d zero bytes
    pt = np.empty((_CHUNK, 256), np.uint32)
    pt[0] = x
    cur = x
    for d in range(1, _CHUNK):
        cur = (cur >> 8) ^ x[cur & 0xFF]
        pt[d] = cur
    _PT = pt
    _PT_REV = np.ascontiguousarray(pt[::-1])
    # advancing a 32-bit state across one CHUNK of zeros decomposes by
    # state byte k into PT[CHUNK-1-k] (byte k needs k plain shifts to reach
    # the low byte, then CHUNK-1-k table-fed steps)
    _ADV = [pt[_CHUNK - 1 - k].tolist() for k in range(4)]


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data)
        if a.nbytes == 0:
            return np.empty(0, np.uint8)
        return a.reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(data), dtype=np.uint8)


# -- C-backed fast paths ----------------------------------------------------
_FAST = None            # (backend_name, fn(bytes_like, value) -> int)
_FAST_PROBED = False
_CHECK_VECTOR = (b"123456789", 0xE3069283)  # canonical CRC-32C test vector


def _probe_fast():
    """Resolve an accelerated CRC-32C backend once, self-checked against
    the canonical test vector so a mis-behaving import can never corrupt
    container checksums."""
    global _FAST, _FAST_PROBED
    _FAST_PROBED = True
    if os.environ.get("REPRO_CRC32C", "").lower() == "software":
        return
    candidates = []
    try:
        import google_crc32c

        candidates.append(("google-crc32c",
                           lambda b, v: google_crc32c.extend(v, b)))
    except ImportError:
        pass
    try:
        import crc32c as _crc32c_mod

        candidates.append(("crc32c",
                           lambda b, v: _crc32c_mod.crc32c(b, v)))
    except ImportError:
        pass
    vec, want = _CHECK_VECTOR
    for name, fn in candidates:
        # zero-copy first (numpy views hand over memoryviews); fall back to
        # a copying wrapper if the backend only takes bytes
        for wrap in (fn, lambda b, v, fn=fn: fn(bytes(b), v)):
            try:
                mv = memoryview(vec)
                if wrap(mv, 0) == want and \
                        wrap(mv[4:], wrap(mv[:4], 0)) == want:
                    _FAST = (name, wrap)
                    return
            except Exception:
                continue


def crc32c_backend() -> str:
    """Name of the active CRC-32C implementation."""
    if not _FAST_PROBED:
        _probe_fast()
    return _FAST[0] if _FAST is not None else "numpy-software"


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like or ndarray); pass a previous return
    as ``value`` to checksum a concatenation incrementally. Routed through
    a C-backed implementation when one is importable (see module
    docstring); the numpy software path is the fallback."""
    if not _FAST_PROBED:
        _probe_fast()
    if _FAST is not None:
        buf = _as_u8(data)
        return int(_FAST[1](buf.data if buf.size else b"", value & _MASK))
    return _crc32c_software(data, value)


def _crc32c_software(data, value: int = 0) -> int:
    """The numpy-vectorized software CRC-32C — always available, and the
    oracle the fast-path cross-check tests compare against."""
    if _TABLE is None:
        _build_tables()
    buf = _as_u8(data)
    crc = (value & _MASK) ^ _MASK
    n = buf.size
    head = n % _CHUNK
    if head:
        tab = _TABLE_LIST
        for b in buf[:head].tolist():
            crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    if n > head:
        a0, a1, a2, a3 = _ADV
        rest = buf[head:]
        # bound temporaries: reduce at most 16 MB of input per slab
        slab = 16384 * _CHUNK
        for s0 in range(0, rest.size, slab):
            chunks = rest[s0:s0 + slab].reshape(-1, _CHUNK)
            if chunks.shape[0] < 64:
                # few blocks: one fancy-indexed gather beats paying numpy
                # per-call overhead _CHUNK times in the position loop
                acc = np.bitwise_xor.reduce(
                    _PT_REV[np.arange(_CHUNK), chunks], axis=1)
            else:
                # many blocks: walk positions — each step gathers from one
                # cache-resident 1 KB table row across every block at once
                acc = np.zeros(chunks.shape[0], np.uint32)
                for j in range(_CHUNK):
                    np.bitwise_xor(acc, _PT_REV[j][chunks[:, j]], out=acc)
            for c in acc.tolist():
                crc = (a0[crc & 0xFF] ^ a1[(crc >> 8) & 0xFF]
                       ^ a2[(crc >> 16) & 0xFF] ^ a3[crc >> 24] ^ c)
    return crc ^ _MASK


# ---------------------------------------------------------------------------
# fsync-ordered commits
# ---------------------------------------------------------------------------
def fsync_file(f) -> None:
    """Flush + fsync an open file object (data reaches the medium before
    any later write is allowed to — the ordering journaled commits need)."""
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: Path) -> None:
    """fsync a directory so a rename published into it survives power loss.
    Best-effort on filesystems that refuse directory fds."""
    try:
        fd = os.open(Path(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: Path, text: str, *, durable: bool = False) -> None:
    """Publish a small text file atomically (tmp + rename); with ``durable``
    the tmp is fsynced before the rename and the directory after it."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    try:
        with open(tmp, "w") as f:
            f.write(text)
            if durable:
                fsync_file(f)
        tmp.replace(path)
        if durable:
            fsync_dir(path.parent)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
