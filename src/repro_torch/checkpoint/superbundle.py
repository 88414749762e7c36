"""Model-level super-bundles — the cold path's on-disk container (format v4).

PR 1's per-layer bundles turned N-tensor layer loads into one open *per
layer*; the super-bundle turns a whole model into ONE open + ONE shared
mmap: every layer's tensors — raw weights AND the §3.1.2 post-transformed
per-kernel cache — live in a single file, laid out in plan/graph order so
the exec chain's cold sweep reads the file front to back.

Layout (format version 4; the full byte-level specification of v1–v4
lives in ``docs/formats.md``)::

    [0:4)     magic  b"NNVS"
    [4:8)     format version (uint32 LE, = 4)
    [8:16)    header length in bytes (uint64 LE)
    [16:20)   CRC-32C of the header JSON (uint32 LE)   [v3+]
    [20:20+H) header — UTF-8 JSON:
              {"generation": n,                 # bumped by every rewrite
               "order":  [layer, ...],          # plan/graph order
               "layers": {layer: {
                   "raw":   [{"name","dtype","shape","offset","nbytes",
                              "crc32c", "quant"?}],
                   "cache": {kernel: [{same-entry-shape}, ...]}}}}
    ...       zero padding to the first 64-byte boundary; the header
              region carries HEADER_SLACK spare bytes so metadata
              updates can be committed in place
    segments  tensor payloads, each starting on a 64-byte boundary,
              grouped layer-after-layer in ``order`` (a layer's raw
              tensors and its cache entries are adjacent)

Offsets are absolute from the start of the file. Dtypes are tagged by
name; bfloat16 is stored natively and read back as ``bf16.BFLOAT16``.
Version-2 files (no checksums, no generation, header JSON at byte 16) and
v3 files (no quantized extents) still open read-only; any rewrite
or in-place commit upgrades them to v4.

Quantized cache extents (format v4): a weight dict written under the
``repro.quant`` companion-key convention (``w:q8``/``w:q4`` +
``w:qscale`` [+ ``w:qzero``]) FOLDS into ONE extent per tensor — entry
``name`` is the base tensor name, ``dtype`` is the scheme tag (``int8``
or ``int4``), the payload is exactly the quantized bytes (CRC-32C over
them), and the entry's ``"quant"`` metadata carries the per-channel
scales/zero-points inline in the header. Reads EXPAND the extent back to
the identical companion dict, so fold → write → read → refold is
bit-exact through rewrites and journal replay, and every durability path
(intent journal, torn-slot resolution, lazy/eager verification, async
``submit_read`` audits) treats quantized extents as ordinary
checksum-protected slots. ``int4`` payloads are nibble-packed uint8 of
shape ``((K+1)//2, N)``; consumers recover the logical K from the layer
spec.

Reading: ``SuperBundle`` holds the single read-only mmap; ``read_raw`` /
``read_cached`` return zero-copy views into it (``materialize=True``
copies the segment out, paying the page-in cost up front — what a
sequential baseline's "read" op must do). ``advise_willneed`` issues
``madvise(MADV_WILLNEED)`` on the extents of the layers a plan will touch
first, so the kernel readahead runs ahead of the prep pipeline.

Durability: in-place cache commits are CRASH-ATOMIC. Every in-place
mutation is preceded by an append-only intent journal record
(``<model>.sbj``, fsynced ahead of any container write) that carries the
slot offsets/lengths/CRC-32Cs of the new payload plus the full new header
bytes. Opening a ``SuperBundle`` replays the journal first
(``recover_journal``): a fully-applied-but-uncommitted transaction is
rolled forward, an untouched one rolls back to the intact old entry, and
a genuinely torn entry is detected by checksum, dropped from the header
(never served — the engine re-materializes it from raw weights), and
reported in ``SuperBundle.dropped``. Raw sections are only ever published
through the atomic tmp+rename rewrite, so raw weights always survive.

Verification: the ``verify`` knob ("never" | "lazy" | "eager") controls
checksum auditing beyond journal recovery. "lazy" (default) verifies an
entry the first time its bytes are *materialized* — zero-copy mmap views
are served unverified, since faulting every page in to checksum it is
exactly the work the mmap path exists to avoid, and crash tears are
already impossible after recovery. "eager" checksums every extent at
open (corrupt cache entries are dropped, corrupt raw raises
``IntegrityError``) — the fsck mode for detecting latent bit-rot.

Space: ``drop_cache_entry`` now just unlinks the entry from the header
(an in-place journaled commit), leaving a dead extent; ``compact``
rewrites the live contents into a fresh container via the same atomic
tmp+rename, reclaiming every dead extent (``reclaimable_bytes`` says how
many bytes that would recover). The engine runs it as the
``LayerStore.maintain()`` hook after ``decide()``.

``migrate`` converts a per-layer bundle ``LayerStore`` tree (``raw/
*.bundle`` + ``cache/<kernel>/*.bundle``) into one super-bundle.
"""
from __future__ import annotations

import base64
import json
import mmap as mmap_mod
import os
import struct
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.checkpoint.bundle import (
    ALIGN, _HEADER_FIXED, _HEADER_FMT, _dtype_from_tag, _dtype_tag, _pad_to,
    atomic_write, read_bundle,
)
from repro_torch.checkpoint.integrity import crc32c, fsync_file
from repro_torch.faults import IntegrityFault
from repro_torch import quant

MAGIC = b"NNVS"
# v4 adds quantized cache extents (folded int8/int4 payloads + header
# "quant" metadata); the fixed prefix is identical to v3, so v3 readers of
# this module's lineage reject v4 by version, not by parse failure
VERSION = 4
# v3+ fixed prefix: magic, version, header length, header CRC-32C
_V3_FIXED_FMT = "<4sIQI"
_V3_FIXED = struct.calcsize(_V3_FIXED_FMT)
# spare header bytes so in-place cache replacement survives small metadata
# growth (shape/nbytes/crc digit changes) without forcing a rewrite
HEADER_SLACK = 256

JOURNAL_SUFFIX = ".sbj"
_JOURNAL_MAGIC = b"SBJ1"
# journal layout per record: magic(4) type(1) payload_len(u32) payload crc(u32)
_JOURNAL_PREFIX = len(_JOURNAL_MAGIC) + 1 + 4
# a clean journal above this size is truncated after the next commit
_JOURNAL_RESET_BYTES = 256 * 1024

LayerWeights = Dict[str, np.ndarray]

# test hook: called at commit phases with context kwargs; a hook that raises
# InjectedCrash simulates power loss mid-commit (nothing in this module
# catches it, exactly like a real crash)
_crash_hook: Optional[Callable[..., None]] = None


class InjectedCrash(BaseException):
    """Raised by crash-injection hooks; derives from BaseException so no
    in-process cleanup path swallows it."""


class IntegrityError(IntegrityFault, ValueError):
    """A checksum-protected region failed verification. Part of the typed
    fault taxonomy (a PermanentFault — retrying re-reads the same bad
    bytes); still a ValueError for pre-taxonomy callers."""


def _hook(phase: str, **ctx):
    if _crash_hook is not None:
        _crash_hook(phase, **ctx)


def _payload(weights: LayerWeights) -> Tuple[List[dict], List[np.ndarray]]:
    """Name-sorted (header entries, contiguous arrays) for one section.

    Format v4 fold point: a quantized companion group (``w:q8``/``w:q4`` +
    ``w:qscale`` [+ ``w:qzero``]) becomes ONE extent named after the base
    tensor — the payload is exactly the quantized bytes (CRC over them),
    the dtype tag is the scheme (``int8``/``int4``), ``shape`` is the
    STORED payload shape (packed, for int4), and the scales/zero-points
    ride in the entry's ``"quant"`` metadata."""
    groups, rest = quant.split_groups(weights)
    entries: List[dict] = []
    arrs: List[np.ndarray] = []
    for name in sorted(set(rest) | set(groups)):
        if name in groups:
            g = groups[name]
            a = np.ascontiguousarray(np.asarray(g["data"]))
            entries.append({"name": name, "dtype": g["scheme"],
                            "shape": list(a.shape), "nbytes": int(a.nbytes),
                            "crc32c": crc32c(a),
                            "quant": quant.quant_meta(g)})
        else:
            a = np.ascontiguousarray(np.asarray(rest[name]))
            entries.append({"name": name, "dtype": _dtype_tag(a.dtype),
                            "shape": list(a.shape), "nbytes": int(a.nbytes),
                            "crc32c": crc32c(a)})
        arrs.append(a)
    return entries, arrs


def journal_path(path: Path) -> Path:
    """The container's intent journal (``model.superbundle`` → ``model.sbj``)."""
    path = Path(path)
    return path.with_suffix(JOURNAL_SUFFIX)


def _next_generation(path: Path) -> int:
    """Generation for a rewrite of ``path``: strictly past the existing
    container's AND past every journal record's, so no stale journal record
    can ever be replayed against the new file — even when the old header is
    torn and unreadable."""
    path = Path(path)
    gen = 0
    try:
        gen = int(read_super_header(path).get("generation", 0)) + 1
    except FileNotFoundError:
        return 0
    except (ValueError, OSError):
        pass  # torn/unreadable old header: fall back to the journal scan
    return max(gen, 1 + max((p.get("gen", 0) for _t, p in
                             _journal_records(journal_path(path))),
                            default=-1))


def write_superbundle(
    path: Path,
    raw: Dict[str, LayerWeights],
    cache: Optional[Dict[str, Dict[str, LayerWeights]]] = None,
    order: Optional[Sequence[str]] = None,
    generation: Optional[int] = None,
) -> int:
    """Write the whole model as one super-bundle (atomic tmp+rename, fsynced).
    ``order`` fixes the on-disk layer layout (plan/graph order); layers
    not listed are appended. ``generation`` stamps the container identity;
    the default derives one strictly past the file being replaced (and its
    journal), so stale journal records can never be replayed against the
    new file. Returns the total file size."""
    path = Path(path)
    if generation is None:
        generation = _next_generation(path)
    cache = cache or {}
    order = list(order) if order is not None else list(raw)
    order += [l for l in raw if l not in order]
    order += sorted(set(cache) - set(order))

    layers_hdr: Dict[str, dict] = {}
    flat: List[Tuple[dict, np.ndarray]] = []
    for layer in order:
        ent_raw, arrs = _payload(raw.get(layer, {}))
        sect = {"raw": ent_raw, "cache": {}}
        flat += list(zip(ent_raw, arrs))
        for kern in sorted(cache.get(layer, {})):
            ent_c, arrs_c = _payload(cache[layer][kern])
            sect["cache"][kern] = ent_c
            flat += list(zip(ent_c, arrs_c))
        layers_hdr[layer] = sect
    header = {"generation": int(generation), "order": order,
              "layers": layers_hdr}

    # offsets depend on the header length which depends on the offsets'
    # digit count — fixed-point iterate, as in the v1 bundle writer
    for _ in range(8):
        hdr_bytes = json.dumps(header, separators=(",", ":")).encode()
        off = _pad_to(_V3_FIXED + len(hdr_bytes) + HEADER_SLACK)
        changed = False
        for e, _a in flat:
            if e.get("offset") != off:
                e["offset"] = off
                changed = True
            off = _pad_to(off + e["nbytes"])
        if not changed:
            break
    else:
        raise RuntimeError(
            f"super-bundle header layout did not converge: {path}")
    total = off

    def _emit(f):
        f.write(struct.pack(_V3_FIXED_FMT, MAGIC, VERSION, len(hdr_bytes),
                            crc32c(hdr_bytes)))
        f.write(hdr_bytes)
        for e, a in flat:
            f.write(b"\0" * (e["offset"] - f.tell()))
            f.write(a.tobytes())
        f.write(b"\0" * (total - f.tell()))

    atomic_write(path, _emit, durable=True)
    # the rewrite published a complete container under a new generation:
    # journal records targeting the old file must never be replayed
    _journal_reset(journal_path(path))
    return total


# ---------------------------------------------------------------------------
# header parsing — ONE validation helper shared by every entry point
# ---------------------------------------------------------------------------
def _check_magic_version(magic: bytes, version: int, src) -> None:
    if magic != MAGIC:
        raise ValueError(f"{src}: not a super-bundle (magic={magic!r})")
    if version > VERSION:
        raise ValueError(
            f"{src}: super-bundle format version {version} is newer than "
            f"the supported version {VERSION}")


def _parse_super_header(buf, src="<buffer>") -> Tuple[dict, int, int]:
    """Validate + parse a super-bundle header out of a bytes-like buffer.
    Returns ``(header, version, header_json_len)``; v3 headers are checksum
    verified (a torn in-place header write raises ``IntegrityError``)."""
    view = memoryview(buf)
    if len(view) < _HEADER_FIXED:
        raise ValueError(f"{src}: truncated super-bundle header")
    magic, version, hlen = struct.unpack_from(_HEADER_FMT, view, 0)
    _check_magic_version(magic, version, src)
    start = _V3_FIXED if version >= 3 else _HEADER_FIXED
    if start + hlen > len(view):
        raise ValueError(f"{src}: truncated super-bundle header")
    raw = bytes(view[start:start + hlen])
    if version >= 3:
        (hcrc,) = struct.unpack_from("<I", view, _HEADER_FIXED)
        if crc32c(raw) != hcrc:
            raise IntegrityError(
                f"{src}: super-bundle header checksum mismatch")
    return json.loads(raw.decode()), version, hlen


def _header_from_file(f, src) -> Tuple[dict, int, bytes]:
    """Read + parse the header from an open file via the shared validator.
    Returns ``(header, version, raw_header_json_bytes)``."""
    f.seek(0, os.SEEK_END)
    size = f.tell()
    f.seek(0)
    pre = f.read(_V3_FIXED)
    if len(pre) < _HEADER_FIXED:
        raise ValueError(f"{src}: truncated super-bundle header")
    magic, version, hlen = struct.unpack_from(_HEADER_FMT, pre, 0)
    _check_magic_version(magic, version, src)
    start = _V3_FIXED if version >= 3 else _HEADER_FIXED
    if start + hlen > size:  # also guards garbage hlen in a torn v3 header
        raise ValueError(f"{src}: truncated super-bundle header")
    buf = pre + f.read(start + hlen - len(pre))
    hdr, ver, _hlen = _parse_super_header(buf, src)
    return hdr, ver, buf[start:start + hlen]


def read_super_header(path: Path) -> dict:
    """Parse a container's header (pure read: no journal recovery)."""
    path = Path(path)
    with open(path, "rb") as f:
        hdr, _version, _raw = _header_from_file(f, path)
    return hdr


def _write_header_inplace(f, hdr_bytes: bytes) -> None:
    """Overwrite the header region (fixed prefix + JSON) and fsync. Only
    called with headers known to fit ahead of the first data segment."""
    f.seek(0)
    f.write(struct.pack(_V3_FIXED_FMT, MAGIC, VERSION, len(hdr_bytes),
                        crc32c(hdr_bytes)))
    f.write(hdr_bytes)
    fsync_file(f)


# ---------------------------------------------------------------------------
# intent journal — append-only, fsync-ordered ahead of in-place writes
# ---------------------------------------------------------------------------
def _journal_records(jp: Path) -> List[Tuple[bytes, dict]]:
    """All valid ``(type, payload)`` records; scanning stops at the first
    torn/garbled record (a crash mid-append only ever tears the tail)."""
    try:
        data = jp.read_bytes()
    except FileNotFoundError:
        return []
    recs: List[Tuple[bytes, dict]] = []
    off = 0
    while off + _JOURNAL_PREFIX + 4 <= len(data):
        if data[off:off + 4] != _JOURNAL_MAGIC:
            break
        rtype = data[off + 4:off + 5]
        (plen,) = struct.unpack_from("<I", data, off + 5)
        end = off + _JOURNAL_PREFIX + plen + 4
        if rtype not in (b"B", b"C") or end > len(data):
            break
        (crc,) = struct.unpack_from("<I", data, off + _JOURNAL_PREFIX + plen)
        body = data[off:off + _JOURNAL_PREFIX + plen]
        if crc32c(body) != crc:
            break
        try:
            payload = json.loads(
                body[_JOURNAL_PREFIX:].decode())
        except ValueError:
            break
        recs.append((rtype, payload))
        off = end
    return recs


def _journal_append(jp: Path, rtype: bytes, payload: dict, *,
                    sync: bool) -> None:
    body = json.dumps(payload, separators=(",", ":")).encode()
    rec = _JOURNAL_MAGIC + rtype + struct.pack("<I", len(body)) + body
    rec += struct.pack("<I", crc32c(rec))
    with open(jp, "ab") as f:
        f.write(rec)
        if sync:
            fsync_file(f)


def _journal_reset(jp: Path) -> None:
    if jp.exists():
        with open(jp, "r+b") as f:
            f.truncate(0)
            fsync_file(f)


def _next_txn(jp: Path) -> int:
    return 1 + max((p.get("txn", 0) for _t, p in _journal_records(jp)),
                   default=0)


def _extent_ok(f, e: dict) -> bool:
    f.seek(e["offset"])
    return crc32c(f.read(e["nbytes"])) == e["crc32c"]


def _record_entries(rec: dict) -> List[dict]:
    """Normalize a BEGIN record to its per-entry view. Batched records carry
    ``entries=[{"layer","kernel","slots"}, ...]``; legacy single-entry
    records carry top-level ``layer``/``kernel``/``slots``."""
    ents = rec.get("entries")
    if ents:
        return ents
    return [{"layer": rec["layer"], "kernel": rec["kernel"],
             "slots": rec.get("slots", [])}]


def _resolve_txn(path: Path, rec: dict) -> List[dict]:
    """Resolve one un-committed BEGIN record against the container: roll
    forward if the new data fully landed, keep old entries where nothing was
    overwritten, otherwise drop exactly the torn entries from the header.
    A record may cover several cache entries (one batched transaction);
    resolution is per-entry. Returns reports of dropped entries."""
    hdr_new = base64.b64decode(rec["header"]["b64"])
    entries = _record_entries(rec)
    all_slots = [s for ent in entries for s in ent["slots"]]
    dropped: List[dict] = []
    with open(path, "r+b") as f:
        cur_hdr: Optional[dict] = None
        cur_raw: Optional[bytes] = None
        try:
            cur_hdr, _ver, cur_raw = _header_from_file(f, path)
        except ValueError:  # torn header (IntegrityError included)
            pass
        if (cur_hdr is not None
                and int(cur_hdr.get("generation", 0)) != rec.get("gen")):
            return []  # stale record from a superseded container: ignore
        if all(_extent_ok(f, s) for s in all_slots):
            # data fully applied — roll forward (restore the new header if
            # the crash tore it or hit before it was written)
            if cur_raw != hdr_new:
                _write_header_inplace(f, hdr_new)
            return []
        if cur_raw is not None and cur_raw != hdr_new:
            # old header still current — every entry whose old bytes verify
            # was not overwritten and survives under the old header; entries
            # whose old extents fail were partially clobbered and are torn
            base = cur_hdr
            torn = []
            for ent in entries:
                old = (cur_hdr["layers"].get(ent["layer"], {})
                       .get("cache", {}).get(ent["kernel"]))
                if old is not None and all(
                        "crc32c" in e and _extent_ok(f, e) for e in old):
                    continue
                torn.append(ent)
            if not torn:
                return []  # pure rollback, all old entries intact
        else:
            # header already (or restored to) the new one: keep entries
            # whose NEW slots fully landed; the rest are torn
            base = json.loads(hdr_new.decode())
            torn = [ent for ent in entries
                    if not all(_extent_ok(f, s) for s in ent["slots"])]
        for ent in torn:
            base["layers"].get(ent["layer"], {}).get("cache", {}).pop(
                ent["kernel"], None)
            dropped.append({"layer": ent["layer"], "kernel": ent["kernel"],
                            "reason": "torn in-place commit rolled back"})
        _write_header_inplace(
            f, json.dumps(base, separators=(",", ":")).encode())
    return dropped


def recover_journal(path: Path) -> List[dict]:
    """Replay/roll back the container's intent journal. Runs automatically
    when a ``SuperBundle`` opens; idempotent; truncates the journal once the
    container is consistent. Returns reports of entries that had to be
    dropped (``[{"layer", "kernel", "reason"}, ...]``)."""
    path = Path(path)
    jp = journal_path(path)
    try:
        if jp.stat().st_size == 0:
            return []
    except FileNotFoundError:
        return []
    recs = _journal_records(jp)
    committed = {p.get("txn") for t, p in recs if t == b"C"}
    dropped: List[dict] = []
    if path.exists():
        for rtype, payload in recs:
            if rtype == b"B" and payload.get("txn") not in committed:
                dropped += _resolve_txn(path, payload)
    _journal_reset(jp)
    return dropped


class SuperBundle:
    """ONE open + ONE shared read-only mmap for a whole model; every
    ``read_raw``/``read_cached`` is a dict of zero-copy views into it.

    Opening replays the intent journal (crash recovery) unless
    ``recover=False``; ``verify`` selects the checksum-audit mode (see the
    module docstring). Entries dropped by recovery or verification are
    reported in ``self.dropped``."""

    def __init__(self, path: Path, *, verify: str = "lazy",
                 recover: bool = True):
        if verify not in ("never", "lazy", "eager"):
            raise ValueError(f"verify must be never|lazy|eager, got {verify}")
        self.path = Path(path)
        self.verify = verify
        self.dropped: List[dict] = []
        # extent bytes served through _views / async waits since open — the
        # measured-cold-bytes counter the benchmarks snapshot around a run
        self.bytes_served = 0
        if recover:
            self.dropped += recover_journal(self.path)
        with open(self.path, "rb") as f:
            self._mm = mmap_mod.mmap(f.fileno(), 0,
                                     access=mmap_mod.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        # separate fd for the async engine's extent preads: the shared
        # mmap stays the sequential-baseline/profiler path, the engine
        # reads the same extents at queue depth through this descriptor
        self._fd: Optional[int] = os.open(self.path, os.O_RDONLY)
        self.last_readahead: Optional[dict] = None
        self.header, self.version, self._hlen = _parse_super_header(
            self._buf, src=self.path)
        self.generation = int(self.header.get("generation", 0))
        self.order: List[str] = list(self.header["order"])
        self._layers: Dict[str, dict] = self.header["layers"]
        self._verified: Set[int] = set()  # id(entry) of checksum-ok entries
        if verify == "eager":
            try:
                self._verify_all()
            except BaseException:
                self.close()
                raise

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        self._buf = None
        try:
            self._mm.close()
        except BufferError:
            pass  # live views pin the map; the GC reclaims it with them
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- introspection ------------------------------------------------------
    def has_raw(self, layer: str) -> bool:
        return layer in self._layers

    def has_cached(self, layer: str, kernel: str) -> bool:
        return kernel in self._layers.get(layer, {}).get("cache", {})

    def kernels_cached(self, layer: str) -> List[str]:
        return list(self._layers.get(layer, {}).get("cache", {}))

    def _all_entries(self, layer: str) -> List[dict]:
        sect = self._layers.get(layer)
        if sect is None:
            return []
        out = list(sect["raw"])
        for ents in sect.get("cache", {}).values():
            out += ents
        return out

    def extent(self, layer: str) -> Optional[Tuple[int, int]]:
        """Byte range covering all of a layer's segments (raw + cache)."""
        ents = self._all_entries(layer)
        if not ents:
            return None
        return (min(e["offset"] for e in ents),
                max(e["offset"] + e["nbytes"] for e in ents))

    # -- verification -------------------------------------------------------
    def _entry_ok(self, e: dict) -> bool:
        if "crc32c" not in e:
            return True  # v2 entry: nothing recorded to verify against
        seg = self._buf[e["offset"]: e["offset"] + e["nbytes"]]
        return crc32c(seg) == e["crc32c"]

    def _verify_raw(self, layer: str, entries: List[dict]) -> None:
        for e in entries:
            if id(e) in self._verified:
                continue
            if not self._entry_ok(e):
                raise IntegrityError(
                    f"{self.path}: raw tensor {layer}/{e['name']} failed "
                    "checksum verification")
            self._verified.add(id(e))

    def _verify_cached(self, layer: str, kernel: str) -> bool:
        """True if the entry's checksums hold; a failing entry is dropped
        from the in-memory header (persisted at the next compaction) and
        reported in ``self.dropped``."""
        ents = self._layers[layer]["cache"][kernel]
        for e in ents:
            if id(e) in self._verified:
                continue
            if not self._entry_ok(e):
                del self._layers[layer]["cache"][kernel]
                self.dropped.append({
                    "layer": layer, "kernel": kernel,
                    "reason": f"checksum mismatch in {e['name']}"})
                return False
            self._verified.add(id(e))
        return True

    def _verify_all(self) -> None:
        for layer in self.order:
            sect = self._layers.get(layer)
            if sect is None:
                continue
            self._verify_raw(layer, sect["raw"])
            for kern in list(sect.get("cache", {})):
                self._verify_cached(layer, kern)

    # -- reads --------------------------------------------------------------
    def _views(self, entries: List[dict], materialize: bool) -> LayerWeights:
        out: LayerWeights = {}
        for e in entries:
            seg = self._buf[e["offset"]: e["offset"] + e["nbytes"]]
            self.bytes_served += e["nbytes"]
            if "quant" in e:
                # v4 expand point: the payload view under the scheme dtype,
                # scales/zero-points decoded from the header metadata
                pv = seg.view(quant.payload_dtype(e["dtype"])).reshape(
                    e["shape"])
                out.update(quant.expand_entry(e["name"], e["quant"], pv,
                                              materialize=materialize))
                continue
            v = seg.view(_dtype_from_tag(e["dtype"])).reshape(e["shape"])
            out[e["name"]] = np.array(v) if materialize else v
        return out

    def read_raw(self, layer: str, *, materialize: bool = False) -> LayerWeights:
        sect = self._layers.get(layer)
        if not sect:
            return {}
        if materialize and self.verify == "lazy":
            self._verify_raw(layer, sect["raw"])
        return self._views(sect["raw"], materialize)

    def read_cached(self, layer: str, kernel: str, *,
                    materialize: bool = False) -> LayerWeights:
        ents = self._layers.get(layer, {}).get("cache", {}).get(kernel)
        if ents is None:
            return {}
        if (materialize and self.verify == "lazy"
                and not self._verify_cached(layer, kernel)):
            return {}  # torn/corrupt entry: never served; caller falls
            #            back to raw + transform
        return self._views(ents, materialize)

    # -- async extent reads --------------------------------------------------
    def submit_read(self, engine, layer: str, *, kernel: Optional[str] = None,
                    injector=None) -> Optional["PendingLayerRead"]:
        """Submit every extent of ``layer`` (raw, or one kernel's cache
        when ``kernel`` is given) to the async I/O engine and return a
        :class:`PendingLayerRead`; ``None`` when the section is absent
        (mirrors ``read_raw``/``read_cached`` returning ``{}``).

        The reaped bytes go through the SAME verification ladder as the
        mmap path — lazily-verified cache mismatches drop the entry and
        surface in ``self.dropped``, raw mismatches raise
        ``IntegrityError`` — except checksums audit the engine-read bytes
        themselves, so the audit covers the path actually served."""
        if self._fd is None:
            raise RuntimeError(f"{self.path}: submit_read on closed bundle")
        sect = self._layers.get(layer)
        if not sect:
            return None
        if kernel is None:
            entries = sect["raw"]
        else:
            entries = sect.get("cache", {}).get(kernel)
            if entries is None:
                return None
        return PendingLayerRead(self, layer, kernel, entries, engine,
                                injector).submit()

    # -- readahead ----------------------------------------------------------
    def advise_willneed(self, layers: Optional[Sequence[str]] = None) -> int:
        """``madvise(MADV_WILLNEED)`` the extents of the given layers (the
        first-k of the plan) so the kernel prefetches ahead of the prep
        pipeline. Returns the number of layers hinted (0 where madvise is
        unavailable) and records coverage in ``self.last_readahead`` so
        callers can tell a hinted run from a silently-unhinted one."""
        wanted = list(self.order if layers is None else layers)
        stats = {"layers_requested": len(wanted), "layers_hinted": 0,
                 "bytes_hinted": 0,
                 "madvise_available": hasattr(self._mm, "madvise")}
        self.last_readahead = stats
        if not stats["madvise_available"]:
            return 0
        page = mmap_mod.PAGESIZE
        for layer in wanted:
            ext = self.extent(layer)
            if ext is None:
                continue
            lo = ext[0] // page * page
            try:
                self._mm.madvise(mmap_mod.MADV_WILLNEED, lo, ext[1] - lo)
                stats["layers_hinted"] += 1
                stats["bytes_hinted"] += ext[1] - lo
            except (ValueError, OSError):
                pass
        return stats["layers_hinted"]

    # -- payload accounting --------------------------------------------------
    def raw_nbytes(self, layer: Optional[str] = None) -> int:
        layers = [layer] if layer is not None else self.order
        return sum(e["nbytes"] for l in layers
                   for e in self._layers.get(l, {"raw": []})["raw"])

    def cache_nbytes(self) -> int:
        return sum(e["nbytes"] for l in self.order
                   for ents in self._layers[l].get("cache", {}).values()
                   for e in ents)

    # -- on-disk accounting ---------------------------------------------------
    def file_size(self) -> int:
        return len(self._buf)

    def cache_disk_bytes(self) -> int:
        """Disk bytes the live cache sections occupy (padded 64-byte slots),
        so ``model + cache`` accounting sums to the real file size."""
        return sum(_pad_to(e["nbytes"]) for l in self.order
                   for ents in self._layers[l].get("cache", {}).values()
                   for e in ents)

    def header_region_bytes(self) -> int:
        """Bytes before the first possible data segment (fixed prefix +
        header JSON + slack, padded)."""
        fixed = _V3_FIXED if self.version >= 3 else _HEADER_FIXED
        return _pad_to(fixed + self._hlen + HEADER_SLACK)

    def live_disk_bytes(self) -> int:
        """Padded slot bytes of every live extent (raw + cache)."""
        return sum(_pad_to(e["nbytes"]) for l in self.order
                   for e in self._all_entries(l))

    def reclaimable_bytes(self) -> int:
        """Dead bytes ``compact`` would reclaim: extents orphaned by
        dropped/superseded cache entries (0 for a freshly-written file)."""
        return max(0, self.file_size() - self.header_region_bytes()
                   - self.live_disk_bytes())


class PendingLayerRead:
    """In-flight async reads for one layer section (raw, or one kernel's
    cache entries).

    ``wait()`` reaps every extent, runs the verification ladder on the
    reaped bytes, and returns ``{name: array}`` of **read-only** typed
    views into engine pool buffers (a corrupt lazily-verified cache
    section returns ``{}`` after dropping the entry, exactly like the
    mmap path).  The views stay valid until ``release()`` recycles the
    buffers — the executor calls that per job, after staging has copied
    everything device-side.

    ``wait()`` is retry-idempotent: a transient fault (injected or real)
    abandons the in-flight tickets — buffers recycle only once the
    backend is done with them — and resets the pending read, so the
    executor's next bounded-retry attempt resubmits cleanly.
    """

    def __init__(self, sb: SuperBundle, layer: str, kernel: Optional[str],
                 entries: List[dict], engine, injector):
        self.sb = sb
        self.layer = layer
        self.kernel = kernel
        self.engine = engine
        self.injector = injector
        self._entries = entries
        self._tickets: Optional[List[tuple]] = None
        self._result: Optional[LayerWeights] = None
        # set by the owning LayerStore: called right after a corrupt cache
        # entry is dropped, so store-level drop reporting sees it without
        # waiting for the reader to reopen
        self.on_drop: Optional[Callable[[], None]] = None

    def submit(self) -> "PendingLayerRead":
        if self._tickets is None and self._result is None:
            tickets = []
            try:
                for e in self._entries:
                    tickets.append((e, self.engine.submit(
                        self.sb._fd, e["offset"], e["nbytes"],
                        key=f"{self.layer}/{e['name']}",
                        injector=self.injector)))
            except BaseException:
                for _, t in tickets:
                    t.abandon()
                raise
            self._tickets = tickets
        return self

    def nbytes(self) -> int:
        return sum(e["nbytes"] for e in self._entries)

    def _reset(self) -> None:
        if self._tickets is not None:
            for _, t in self._tickets:
                t.abandon()
            self._tickets = None

    def wait(self, timeout: Optional[float] = None) -> LayerWeights:
        if self._result is not None:
            return self._result
        self.submit()
        out: LayerWeights = {}
        try:
            for e, t in self._tickets:
                view = t.wait(timeout)
                if (self.sb.verify != "never"
                        and id(e) not in self.sb._verified
                        and "crc32c" in e
                        and crc32c(view) != e["crc32c"]):
                    if self.kernel is None:
                        raise IntegrityError(
                            f"{self.sb.path}: raw tensor "
                            f"{self.layer}/{e['name']} failed checksum "
                            "verification")
                    # cache tear: drop the entry like _verify_cached and
                    # let the caller fall back to raw + transform
                    self.sb._layers[self.layer]["cache"].pop(self.kernel,
                                                             None)
                    self.sb.dropped.append({
                        "layer": self.layer, "kernel": self.kernel,
                        "reason": f"checksum mismatch in {e['name']}"})
                    self._reset()
                    self._result = {}
                    if self.on_drop is not None:
                        self.on_drop()
                    return self._result
                self.sb._verified.add(id(e))
                self.sb.bytes_served += e["nbytes"]
                if "quant" in e:
                    pv = view.view(quant.payload_dtype(
                        e["dtype"])).reshape(e["shape"])
                    out.update(quant.expand_entry(e["name"], e["quant"], pv))
                else:
                    out[e["name"]] = view.view(
                        _dtype_from_tag(e["dtype"])).reshape(e["shape"])
        except IntegrityError:
            self._reset()
            raise
        except Exception:
            self._reset()  # transient: next retry attempt resubmits
            raise
        self._result = out
        return out

    def abort(self) -> None:
        """Interrupt a waiter parked in the engine's emulated-disk pacing
        (warm-state race loser): flags only — buffers are untouched, so a
        waiter already past pacing (verifying/parsing views) completes
        normally. ``release()`` still recycles everything at job end."""
        if self._tickets is not None:
            for _, t in self._tickets:
                t.interrupt()

    def release(self) -> None:
        if self._tickets is not None:
            for _, t in self._tickets:
                t.abandon()


# ---------------------------------------------------------------------------
# mutation: journaled in-place commit / rewrite-on-grow / drop / compact
# ---------------------------------------------------------------------------
def _load_all(sb: SuperBundle):
    """Live contents as zero-copy views, for a rewrite. Unless the reader
    was opened with ``verify="never"``, every extent is audited on the way
    through: a rewrite restamps fresh checksums, so copying unverified
    bytes forward would launder latent bit-rot into "verified" data.
    Corrupt cache entries are dropped (reported in ``sb.dropped``);
    corrupt raw raises ``IntegrityError``."""
    audit = sb.verify != "never"
    raw: Dict[str, LayerWeights] = {}
    cache: Dict[str, Dict[str, LayerWeights]] = {}
    for l in sb.order:
        sect = sb._layers.get(l)
        if audit and sect:
            sb._verify_raw(l, sect["raw"])
        raw[l] = sb.read_raw(l)
        ks: Dict[str, LayerWeights] = {}
        for k in list(sb.kernels_cached(l)):
            if audit and not sb._verify_cached(l, k):
                continue  # dropped + reported via sb.dropped
            ks[k] = sb.read_cached(l, k)
        cache[l] = ks
    return raw, cache


def _slot_sizes(sb: SuperBundle) -> Dict[int, int]:
    """id(entry) -> writable slot size (distance to the next live segment or
    to EOF) — how far an in-place replacement may grow without moving data.
    Dead extents left by dropped entries merge into the preceding slot."""
    all_e = sorted((e for l in sb.order for e in sb._all_entries(l)),
                   key=lambda e: e["offset"])
    size = len(sb._buf)
    slots: Dict[int, int] = {}
    for e, nxt in zip(all_e, all_e[1:] + [None]):
        end = nxt["offset"] if nxt is not None else size
        slots[id(e)] = end - e["offset"]
    return slots


def _first_data_offset(sb: SuperBundle) -> int:
    offs = [e["offset"] for l in sb.order for e in sb._all_entries(l)]
    return min(offs) if offs else sb.file_size()


def _commit_inplace(path: Path, sb: SuperBundle, entries: List[dict],
                    hdr_bytes: bytes,
                    slots: List[Tuple[int, bytes]]) -> None:
    """The crash-atomic in-place commit: journal the intent (slot checksums
    + full new header), fsync it AHEAD of any container write, then write
    payload slots and the new header, fsync, and mark the transaction
    committed — ONE fsync pair however many cache entries the transaction
    covers. ``entries`` is ``[{"layer","kernel","slots":[meta]}, ...]``;
    any tear in between is resolved per-entry by ``recover_journal`` at the
    next open."""
    jp = journal_path(path)
    begin = {
        "txn": _next_txn(jp), "gen": sb.generation,
        "entries": entries,
        "slots": [s for ent in entries for s in ent["slots"]],
        "header": {"len": len(hdr_bytes), "crc32c": crc32c(hdr_bytes),
                   "b64": base64.b64encode(hdr_bytes).decode()},
    }
    if len(entries) == 1:  # legacy single-entry shape, kept for introspection
        begin["layer"] = entries[0]["layer"]
        begin["kernel"] = entries[0]["kernel"]
    _hook("journal", record=begin, journal=jp)
    _journal_append(jp, b"B", begin, sync=True)
    _hook("journal-synced", record=begin, journal=jp)
    with open(path, "r+b") as f:
        for off, payload in slots:
            _hook("slot", file=f, offset=off, payload=payload)
            f.seek(off)
            f.write(payload)
        _hook("slots-written", file=f)
        _hook("header", file=f, header=hdr_bytes)
        _write_header_inplace(f, hdr_bytes)  # fsyncs slots + header together
        _hook("header-written", file=f)
    _journal_append(jp, b"C", {"txn": begin["txn"]}, sync=False)
    if jp.stat().st_size > _JOURNAL_RESET_BYTES:
        _journal_reset(jp)


def _try_inplace_many(
        path: Path, sb: SuperBundle,
        payloads: Dict[Tuple[str, str],
                       Tuple[List[dict], List[np.ndarray]]]) -> bool:
    """Attempt ONE journaled in-place transaction replacing every entry in
    ``payloads``. All-or-nothing: if any entry's tensors changed names, grew
    past its slot, or the combined header outgrows the header region, no
    bytes are touched and the caller falls back to a rewrite."""
    if sb.version < 3:
        return False  # pre-checksum container: upgrade via full rewrite
    slots = _slot_sizes(sb)
    # candidate header on a deep copy — sb.header must stay untouched unless
    # the in-place path actually commits
    hdr = json.loads(json.dumps(sb.header))
    rec_entries: List[dict] = []
    flat: List[Tuple[int, bytes]] = []
    for (layer, kernel), (entries_new, arrs) in payloads.items():
        old = sb._layers[layer]["cache"][kernel]
        if [e["name"] for e in old] != [e["name"] for e in entries_new]:
            return False
        if any(en["nbytes"] > slots[id(eo)]
               for eo, en in zip(old, entries_new)):
            return False
        for eo, en in zip(hdr["layers"][layer]["cache"][kernel], entries_new):
            eo.update(dtype=en["dtype"], shape=en["shape"],
                      nbytes=en["nbytes"], crc32c=en["crc32c"])
            # carry (or clear) the v4 quantization metadata with the entry
            if "quant" in en:
                eo["quant"] = en["quant"]
            else:
                eo.pop("quant", None)
        metas = []
        for eo, a in zip(old, arrs):
            b = a.tobytes()
            flat.append((eo["offset"], b))
            metas.append({"offset": eo["offset"], "nbytes": len(b),
                          "crc32c": crc32c(b)})
        rec_entries.append({"layer": layer, "kernel": kernel, "slots": metas})
    hdr_bytes = json.dumps(hdr, separators=(",", ":")).encode()
    if _V3_FIXED + len(hdr_bytes) > _first_data_offset(sb):
        return False
    _commit_inplace(path, sb, rec_entries, hdr_bytes, flat)
    return True


def set_cache_entries(
        path: Path,
        updates: Dict[Tuple[str, str], LayerWeights], *,
        verify: str = "lazy") -> dict:
    """Commit several cache-entry writes as ONE transaction. When every
    entry already exists and fits its slot (the decide() refresh pattern),
    this is a single journaled in-place commit — one journal fsync + one
    container fsync, instead of a pair per entry. Anything that grows or is
    new falls back to one atomic rewrite covering all updates. Returns
    ``{"mode": "inplace"|"rewrite", "dropped": [...]}`` (recovery/audit
    drop reports from opening the container)."""
    path = Path(path)
    payloads = {(l, k): _payload(w) for (l, k), w in updates.items()}
    with SuperBundle(path, verify=verify) as sb:
        dropped = list(sb.dropped)
        if (payloads
                and all(sb.has_cached(l, k) for l, k in payloads)
                and _try_inplace_many(path, sb, payloads)):
            return {"mode": "inplace", "dropped": dropped}
        raw, cache = _load_all(sb)
        dropped = list(sb.dropped)  # _load_all may audit-drop more
        order = list(sb.order)
        for (layer, kernel), weights in updates.items():
            if layer not in order:
                order.append(layer)
                raw.setdefault(layer, {})
            # keep the ORIGINAL weight dict (companion keys included) so the
            # rewrite's _payload refolds quantized groups instead of writing
            # a folded payload as a plain tensor with its metadata lost
            cache.setdefault(layer, {})[kernel] = dict(weights)
        write_superbundle(path, raw, cache, order=order,
                          generation=sb.generation + 1)
    return {"mode": "rewrite", "dropped": dropped}


def set_cache_entry(path: Path, layer: str, kernel: str,
                    weights: LayerWeights) -> str:
    """Append/replace one layer's post-transformed cache entry. In-place
    (crash-atomic, journaled) when the payload fits the existing slots and
    the header region; else rewrite-on-grow (atomic tmp+rename). Returns
    ``"inplace"`` or ``"rewrite"``."""
    return set_cache_entries(path, {(layer, kernel): weights})["mode"]


def drop_cache_entry(path: Path, layer: str, kernel: str) -> bool:
    """Remove a cache entry. On a v3 container this is a journaled in-place
    header commit that leaves the extent dead on disk — O(header), not
    O(file) — to be reclaimed by the next ``compact``. Older containers
    fall back to the compacting rewrite. Returns whether the entry existed."""
    path = Path(path)
    with SuperBundle(path) as sb:
        if not sb.has_cached(layer, kernel):
            return False
        if sb.version >= 3:
            hdr = json.loads(json.dumps(sb.header))
            hdr["layers"][layer]["cache"].pop(kernel)
            hdr_bytes = json.dumps(hdr, separators=(",", ":")).encode()
            if _V3_FIXED + len(hdr_bytes) <= _first_data_offset(sb):
                _commit_inplace(
                    path, sb,
                    [{"layer": layer, "kernel": kernel, "slots": []}],
                    hdr_bytes, [])
                return True
        raw, cache = _load_all(sb)
        del cache[layer][kernel]
        write_superbundle(path, raw, cache, order=sb.order,
                          generation=sb.generation + 1)
    return True


def compact(path: Path, *, order: Optional[Sequence[str]] = None) -> dict:
    """Reclaim dead extents (dropped/superseded cache entries) by rewriting
    the live contents into a fresh container via the atomic tmp+rename
    publish. Every extent is checksum-verified on the way through (a
    corrupt cache entry is dropped, not copied forward; corrupt raw
    raises); the generation is bumped and the journal reset. Returns
    ``{"file_size", "reclaimed_bytes", "dropped"}``."""
    path = Path(path)
    with SuperBundle(path, verify="lazy") as sb:
        before = sb.file_size()
        raw, cache = _load_all(sb)
        dropped = list(sb.dropped)
        keep_order = list(order) if order is not None else list(sb.order)
        size = write_superbundle(path, raw, cache, order=keep_order,
                                 generation=sb.generation + 1)
    return {"file_size": size, "reclaimed_bytes": before - size,
            "dropped": dropped}


# ---------------------------------------------------------------------------
# migration: per-layer bundle LayerStore tree -> one super-bundle
# ---------------------------------------------------------------------------
def migrate(src_root: Path, dest: Path,
            order: Optional[Sequence[str]] = None) -> Path:
    """Convert a per-layer bundle store (``raw/*.bundle`` +
    ``cache/<kernel>/*.bundle``) into one super-bundle at ``dest`` (a file
    path, or a directory that receives ``model.superbundle``). Layer names
    are recovered from bundle file stems — names whose ``/`` was flattened
    to ``_`` on write stay flattened."""
    src = Path(src_root)
    dest = Path(dest)
    if dest.is_dir():
        dest = dest / "model.superbundle"
    raw: Dict[str, LayerWeights] = {}
    for p in sorted((src / "raw").glob("*.bundle")):
        raw[p.name[: -len(".bundle")]] = read_bundle(p, mmap=True)
    cache: Dict[str, Dict[str, LayerWeights]] = {}
    cdir = src / "cache"
    if cdir.exists():
        for kdir in sorted(d for d in cdir.iterdir() if d.is_dir()):
            for p in sorted(kdir.glob("*.bundle")):
                layer = p.name[: -len(".bundle")]
                cache.setdefault(layer, {})[kdir.name] = read_bundle(
                    p, mmap=True)
    write_superbundle(dest, raw, cache, order=order)
    return dest
