"""Checkpoint I/O: ``LayerStore``.

  * ``LayerStore`` — per-layer weight storage on disk, the cold-inference
    engine's substrate. Raw weights live under ``raw/``; post-transformed
    weights (the paper's §3.1.2 cache) under ``cache/<kernel>/``.

    The default format is the packed single-file *bundle*
    (``checkpoint/bundle.py``): all tensors of a layer in one file with
    64-byte-aligned segments, read back as ONE open + one ``np.memmap``
    (zero-copy, read-only views) instead of N opens + N full copies —
    MNN-style pre-arranged layouts for sequential, cheap cold reads.
    ``fmt="super"`` goes one step further (``checkpoint/superbundle.py``):
    the whole model — raw weights and the per-kernel §3.1.2 cache — lives
    in ONE file (``model.superbundle``) behind one shared mmap; reads are
    zero-copy views into it and ``readahead()`` issues madvise(WILLNEED)
    hints for the layers a plan touches first. Writes are buffered: raw
    installs and first-time cache materializations coalesce into ONE
    atomic container rewrite at the next flush point (raw read /
    accounting / readahead), while replacing a cache entry already in the
    container goes through the super-bundle's in-place/rewrite-on-grow
    path — crash-atomic since format v3 (intent journal + per-extent
    CRC-32C; ``verify=`` picks the checksum-audit mode and ``maintain()``
    compacts dead cache extents — see ``checkpoint/superbundle.py`` and
    ``docs/formats.md``). ``fmt="npy"`` keeps the legacy per-tensor ``.npy`` layout (one
    file per tensor, bf16 stored as uint16 views) for format benchmarks
    and the bundle-vs-legacy equivalence tests.

    ``open_count`` tracks the file opens the read path performs (the
    number the cold-I/O benchmarks compare across formats: N_tensors for
    npy, N_layers for bundle, 1 per model for super).

  * ``save_pytree``/``load_pytree`` — training checkpoints (params and
    optimizer state): one ``leaf_{i:05d}.npy`` a leaf in JAX's leaf order
    (``repro_torch.pytree``), bf16 widened to f32 and recorded as
    ``"bfloat16"``, and an ``index.json`` whose ``leaves`` (key, file,
    dtype) are the reference's, so a checkpoint written by either package
    loads in the other.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.checkpoint.bundle import (
    _dtype_from_tag, _parse_header_from, read_bundle, write_bundle,
)
from repro_torch.checkpoint.integrity import (  # noqa: F401  (re-exported helpers)
    atomic_write_text, crc32c, fsync_dir, fsync_file,
)
from repro_torch.checkpoint.superbundle import (
    SuperBundle, drop_cache_entry, set_cache_entries, set_cache_entry,  # noqa: F401
    write_superbundle,
)
from repro_torch.faults import classify
from repro_torch import quant


def _safe(name: str) -> str:
    return name.replace("/", "_")


# ---------------------------------------------------------------------------
# async read handles (submit/reap pairs over repro.ioengine)
# ---------------------------------------------------------------------------
class _ImmediateRead:
    """Pending-read interface over bytes already in hand (buffered
    super-bundle writes, npy fallback): wait() returns instantly."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        self._w = weights

    def wait(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self._w

    def nbytes(self) -> int:
        return sum(int(v.nbytes) for v in self._w.values())

    def abort(self) -> None:
        pass

    def release(self) -> None:
        pass


class _PendingBundleRead:
    """Whole-file async read of one per-layer bundle: submit ONE read for
    the blob, parse the header out of the reaped buffer (same trick as
    ``read_bundle``), serve read-only views.  Retry-idempotent like the
    super-bundle's ``PendingLayerRead``: a fault abandons the ticket and
    the next ``wait()`` resubmits."""

    def __init__(self, store: "LayerStore", path: Path, engine, injector,
                 key: str):
        self.store = store
        self.path = path
        self.engine = engine
        self.injector = injector
        self.key = key
        self._fd: Optional[int] = None
        self._ticket = None
        self._size = 0
        self._result: Optional[Dict[str, np.ndarray]] = None

    def submit(self) -> "_PendingBundleRead":
        if self._ticket is None and self._result is None:
            self._fd = os.open(self.path, os.O_RDONLY)
            self.store.open_count += 1
            try:
                self._size = os.fstat(self._fd).st_size
                self._ticket = self.engine.submit(
                    self._fd, 0, self._size, key=self.key,
                    injector=self.injector)
            except BaseException:
                os.close(self._fd)
                self._fd = None
                raise
        return self

    def nbytes(self) -> int:
        return self._size

    def _reset(self) -> None:
        if self._ticket is not None:
            self._ticket.abandon()
            self._ticket = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def abort(self) -> None:
        """Flag-only interrupt for a waiter parked in emulated-disk pacing
        (warm-state race loser); never touches the buffer — see
        ``ReadTicket.interrupt``."""
        if self._ticket is not None:
            self._ticket.interrupt()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        if self._result is not None:
            return self._result
        self.submit()
        try:
            buf = self._ticket.wait(timeout)
            out: Dict[str, np.ndarray] = {}
            for e in _parse_header_from(buf)["tensors"]:
                seg = buf[e["offset"]: e["offset"] + e["nbytes"]]
                out[e["name"]] = seg.view(
                    _dtype_from_tag(e["dtype"])).reshape(e["shape"])
        except Exception:
            self._reset()  # transient: the retry's next wait() resubmits
            raise
        os.close(self._fd)  # payload fully reaped; only the buffer lives on
        self._fd = None
        self._result = out
        return out

    def release(self) -> None:
        if self._ticket is not None:
            self._ticket.abandon()
            self._ticket = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


# ---------------------------------------------------------------------------
# legacy per-tensor .npy layout (fmt="npy")
# ---------------------------------------------------------------------------
def _save_arr(path_base: Path, v: np.ndarray):
    """np.save with bf16 support (stored as uint16 + .bf16.npy suffix —
    numpy has no bfloat16 to round-trip through .npy)."""
    v = np.asarray(v)
    if bf16.is_bf16(v):
        np.save(path_base.with_suffix(".bf16.npy"), v.view(np.uint16),
                allow_pickle=False)
    else:
        np.save(path_base.with_suffix(".npy"), v, allow_pickle=False)


def _load_dir(d: Path) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for p in sorted(d.glob("*.npy")):
        if p.name.endswith(".bf16.npy"):
            out[p.name[: -len(".bf16.npy")]] = np.load(
                p, allow_pickle=False).view(bf16.BFLOAT16)
        else:
            out[p.stem] = np.load(p, allow_pickle=False)
    return out


class LayerStore:
    """Per-layer weight store. ``fmt="bundle"`` (default) packs each layer
    into one aligned blob; ``fmt="super"`` packs the whole model into one;
    reads default to zero-copy mmap views (``mmap=False`` forces a
    materializing read that pays the byte movement up front)."""

    def __init__(self, root: Path, *, fmt: str = "bundle", mmap: bool = True,
                 verify: str = "lazy"):
        assert fmt in ("bundle", "npy", "super"), fmt
        assert verify in ("never", "lazy", "eager"), verify
        self.root = Path(root)
        self.fmt = fmt
        self.mmap = mmap
        self.verify = verify  # super-bundle checksum audit mode
        self.open_count = 0  # file opens performed by reads
        self.cache_write_count = 0  # write_cached calls (cache materializations)
        # chaos hook: a repro.faults.FaultInjector with "store.read_raw" /
        # "store.read_cached" sites armed (None = no injection)
        self.fault_injector = None
        # cache entries dropped by journal recovery / checksum verification
        # ({"layer", "kernel", "reason"}; fmt="super" only)
        self.dropped_entries: List[dict] = []
        # coverage of the last readahead() call (satellite of the async
        # engine work: a silent madvise no-op is now visible downstream)
        self.readahead_stats: Optional[Dict[str, Any]] = None
        (self.root / "raw").mkdir(parents=True, exist_ok=True)
        (self.root / "cache").mkdir(parents=True, exist_ok=True)
        if fmt == "super":
            self._super_path = self.root / "model.superbundle"
            self._pending_raw: Dict[str, Dict[str, np.ndarray]] = {}
            self._pending_cache: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
            self._pending_drop: Set[Tuple[str, str]] = set()
            self._order: List[str] = []  # write order == graph order
            self._reader: Optional[SuperBundle] = None
            self._reader_seen = 0  # reader.dropped entries already harvested
            # container bytes served by readers already closed; live reader
            # bytes are added on top by bytes_served()
            self._bytes_served_base = 0
            self._maintain_thread = None
            self._maintain_result = None

    # -- super-bundle plumbing ----------------------------------------------
    def _super_dirty(self) -> bool:
        return bool(self._pending_raw or self._pending_cache
                    or self._pending_drop)

    def _invalidate_reader(self):
        if self._reader is not None:
            # harvest entries the reader dropped AFTER open (lazy checksum
            # audits on materializing reads) so dropped_entries stays the
            # complete report
            self.dropped_entries += self._reader.dropped[self._reader_seen:]
            self._bytes_served_base += self._reader.bytes_served
            self._reader.close()
            self._reader = None

    def bytes_served(self) -> int:
        """Container extent bytes served through reads (mmap views + async
        waits) across all reader generations — the measured cold-bytes
        counter the quantized-cache benchmarks snapshot around a run.
        0 for non-super formats (no shared counter to aggregate)."""
        if self.fmt != "super":
            return 0
        live = self._reader.bytes_served if self._reader is not None else 0
        return self._bytes_served_base + live

    def close(self):
        """Release the shared super-bundle mmap (the next read reopens it) —
        lets benchmarks measure truly cold opens. No-op for other fmts."""
        if self.fmt == "super":
            self._invalidate_reader()

    def _quiesce_maintenance(self):
        """Join a live background compaction before mutating the container —
        two concurrent rewrites would interleave into the same tmp file. A
        failed compaction surfaces here (or at ``maintain_wait()``)."""
        t = getattr(self, "_maintain_thread", None)
        if t is not None:
            self.maintain_wait()

    def _super_flush(self):
        """Merge all buffered writes/drops into the container in ONE atomic
        rewrite (write_raw during model install is buffered so an N-layer
        install costs one rewrite, not N). When the only pending work is
        cache-entry writes against an existing container — the decide()
        refresh pattern — they commit as ONE batched intent-journal
        transaction instead (one fsync pair however many entries)."""
        if not self._super_dirty():
            return
        self._quiesce_maintenance()
        if (not self._pending_raw and not self._pending_drop
                and self._super_path.exists()):
            self._invalidate_reader()
            res = set_cache_entries(self._super_path,
                                    dict(self._pending_cache),
                                    verify=self.verify)
            self.dropped_entries += res["dropped"]
            self._pending_cache.clear()
            return
        raw: Dict[str, Dict[str, np.ndarray]] = {}
        cache: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        order: List[str] = []
        generation = 0
        sb = (SuperBundle(self._super_path, verify=self.verify)
              if self._super_path.exists() else None)
        try:
            if sb is not None:
                from repro_torch.checkpoint.superbundle import _load_all

                generation = sb.generation + 1
                order = list(sb.order)
                # _load_all audits every extent it copies forward (unless
                # verify="never") — the rewrite restamps fresh checksums,
                # so unverified bytes would launder bit-rot into the new
                # container; corrupt cache entries drop, corrupt raw raises
                raw, cache = _load_all(sb)
                self.dropped_entries += sb.dropped
            for l, w in self._pending_raw.items():
                raw[l] = w
            for l in self._order:
                if l not in order:
                    order.append(l)
            for (l, k) in self._pending_drop:
                cache.get(l, {}).pop(k, None)
            for (l, k), w in self._pending_cache.items():
                cache.setdefault(l, {})[k] = w
                raw.setdefault(l, {})
                if l not in order:
                    order.append(l)
            write_superbundle(self._super_path, raw, cache, order=order,
                              generation=generation)
        finally:
            if sb is not None:
                sb.close()
        self._pending_raw.clear()
        self._pending_cache.clear()
        self._pending_drop.clear()
        self._invalidate_reader()

    def _super(self, *, flush_all: bool = False) -> Optional[SuperBundle]:
        """The shared reader. Pending RAW writes force a flush (raw reads
        must see them in the file); pending cache writes/drops do NOT —
        cache queries are served from the buffers until something needs the
        file complete (``flush_all``), which keeps an N-layer cache
        materialization at one container rewrite instead of N."""
        if flush_all or self._pending_raw:
            self._super_flush()
        if self._reader is None and self._super_path.exists():
            self._reader = SuperBundle(self._super_path, verify=self.verify)
            self.open_count += 1
            if self._reader.dropped:
                self.dropped_entries += self._reader.dropped
            self._reader_seen = len(self._reader.dropped)
        return self._reader

    def readahead(self, layers) -> int:
        """madvise(WILLNEED)-style hints for the layers a plan touches
        first. Effective for ``fmt="super"``; 0 otherwise.  Coverage of
        the last call lands in ``readahead_stats`` (hinted layer/byte
        counts + whether madvise exists at all) so runs where the hint
        silently no-ops are distinguishable downstream."""
        layers = list(layers)
        if self.fmt != "super":
            self.readahead_stats = {
                "layers_requested": len(layers), "layers_hinted": 0,
                "bytes_hinted": 0, "madvise_available": False}
            return 0
        sb = self._super(flush_all=True)
        if sb is None:
            self.readahead_stats = {
                "layers_requested": len(layers), "layers_hinted": 0,
                "bytes_hinted": 0, "madvise_available": False}
            return 0
        hinted = sb.advise_willneed(layers)
        self.readahead_stats = dict(sb.last_readahead or {})
        return hinted

    def maintain(self, *, min_reclaim_bytes: int = 1,
                 background: bool = False) -> Dict[str, Any]:
        """Storage maintenance hook (the engine calls it after ``decide()``):
        flush buffered writes, then compact the super-bundle if dropped/
        superseded cache extents left at least ``min_reclaim_bytes`` dead on
        disk. ``background=True`` runs the compaction in a daemon thread
        (call ``maintain_wait()`` before mutating the store again). No-op
        for non-super formats."""
        out: Dict[str, Any] = {"compacted": False, "reclaimed_bytes": 0,
                               "dropped": []}
        if self.fmt != "super":
            return out
        self._quiesce_maintenance()  # never two compactions in flight
        sb = self._super(flush_all=True)
        if sb is None:
            return out
        reclaim = sb.reclaimable_bytes()
        if reclaim < max(min_reclaim_bytes, 1):
            return out
        self._invalidate_reader()

        def _run():
            from repro_torch.checkpoint.superbundle import compact

            return compact(self._super_path)

        if background:
            import threading

            self._maintain_result = None  # (stats, exception)

            def _bg():
                try:
                    self._maintain_result = (_run(), None)
                except BaseException as exc:  # surfaced by maintain_wait()
                    self._maintain_result = (None, exc)

            t = threading.Thread(target=_bg, name="superbundle-compact",
                                 daemon=True)
            t.start()
            self._maintain_thread = t
            # reclaimed_bytes here is the pre-compaction estimate; call
            # maintain_wait() for the real stats (or the failure)
            out.update(compacted=True, background=True,
                       reclaimed_bytes=reclaim)
            return out
        stats = _run()
        self.dropped_entries += stats["dropped"]
        out.update(compacted=True, reclaimed_bytes=stats["reclaimed_bytes"],
                   dropped=stats["dropped"])
        return out

    def warm_verify(self, layers) -> int:
        """Materialize the given layers' raw entries now so their one-off
        lazy CRC audit lands here instead of inside a caller's timed read
        region. No-op (returns 0) unless ``fmt="super"`` with
        ``verify="lazy"`` — the only configuration that audits reads."""
        if self.fmt != "super" or self.verify != "lazy":
            return 0
        n = 0
        for name in layers:
            self.read_raw(name, mmap=False)
            n += 1
        return n

    def maintain_wait(self) -> Optional[dict]:
        """Join a background compaction started by ``maintain()``: returns
        its real stats, re-raises its failure, or returns None if no
        background compaction is pending."""
        t = getattr(self, "_maintain_thread", None)
        if t is None:
            return None
        t.join()
        self._maintain_thread = None
        stats, exc = self._maintain_result
        self._maintain_result = None
        if exc is not None:
            raise exc
        self.dropped_entries += stats["dropped"]
        return stats

    # -- layout -------------------------------------------------------------
    def _raw_path(self, layer: str) -> Path:
        base = self.root / "raw" / _safe(layer)
        # NOT with_suffix: dotted layer names ("block.0") must not collide
        return base.parent / (base.name + ".bundle") if self.fmt == "bundle" else base

    def _cache_path(self, layer: str, kernel: str) -> Path:
        base = self.root / "cache" / kernel / _safe(layer)
        return base.parent / (base.name + ".bundle") if self.fmt == "bundle" else base

    def _write(self, path: Path, weights: Dict[str, np.ndarray]):
        if self.fmt == "bundle":
            path.parent.mkdir(parents=True, exist_ok=True)
            write_bundle(path, weights)
        else:
            path.mkdir(parents=True, exist_ok=True)
            for k, v in weights.items():
                _save_arr(path / k, v)

    def _read(self, path: Path, mmap: Optional[bool]) -> Dict[str, np.ndarray]:
        if not path.exists():
            return {}  # weightless (stateless) layers have no file on disk
        if self.fmt == "bundle":
            use = self.mmap if mmap is None else mmap
            self.open_count += 1
            return read_bundle(path, mmap=use)
        self.open_count += sum(1 for _ in path.glob("*.npy"))
        return _load_dir(path)

    # -- raw weights --------------------------------------------------------
    def write_raw(self, layer: str, weights: Dict[str, np.ndarray]):
        if self.fmt == "super":
            self._pending_raw[layer] = {
                k: np.asarray(v) for k, v in weights.items()}
            if layer not in self._order:
                self._order.append(layer)
            return
        self._write(self._raw_path(layer), weights)

    def read_raw(self, layer: str, *, mmap: Optional[bool] = None) -> Dict[str, np.ndarray]:
        if self.fault_injector is not None:
            self.fault_injector.maybe_fault("store.read_raw", layer)
        try:
            if self.fmt == "super":
                sb = self._super()
                if sb is None:
                    return {}
                use = self.mmap if mmap is None else mmap
                return sb.read_raw(layer, materialize=not use)
            return self._read(self._raw_path(layer), mmap)
        except OSError as e:
            # transient-errno I/O errors become typed retryable ReadFaults;
            # real conditions (ENOENT, EACCES, ...) pass through unchanged
            f = classify(e, site="store.read_raw", layer=layer)
            if f is e:
                raise
            raise f from e

    def raw_bytes(self, layer: str) -> int:
        if self.fmt == "super":
            sb = self._super()
            return sb.raw_nbytes(layer) if sb is not None else 0
        p = self._raw_path(layer)
        if self.fmt == "bundle":
            return p.stat().st_size if p.exists() else 0
        return sum(q.stat().st_size for q in p.glob("*.npy"))

    def cached_bytes(self, layer: str, kernel: str) -> int:
        """Extent bytes a cold read of one cache entry costs. For
        ``fmt="super"`` this is the FOLDED payload size — a quantized
        entry's int8/int4 bytes, not its dequantized footprint — i.e. the
        read-cost side of the scheduler's smaller-read/dequant trade."""
        if self.fmt == "super":
            pend = self._pending_cache.get((layer, kernel))
            if pend is not None:
                groups, rest = quant.split_groups(pend)
                return (sum(int(np.asarray(v).nbytes) for v in rest.values())
                        + sum(int(np.asarray(g["data"]).nbytes)
                              for g in groups.values()))
            sb = self._super()
            if sb is None or not sb.has_cached(layer, kernel):
                return 0
            return sum(e["nbytes"]
                       for e in sb._layers[layer]["cache"][kernel])
        p = self._cache_path(layer, kernel)
        if self.fmt == "bundle":
            return p.stat().st_size if p.exists() else 0
        return sum(q.stat().st_size for q in p.glob("*.npy"))

    # -- post-transformed cache (§3.1.2) ------------------------------------
    def write_cached(self, layer: str, kernel: str, weights: Dict[str, np.ndarray]):
        self.cache_write_count += 1
        if self.fmt == "super":
            self._quiesce_maintenance()
            self._pending_drop.discard((layer, kernel))
            # buffer first materializations AND replacements alike: at the
            # next flush point, N replacements commit as ONE batched
            # journal transaction (one fsync pair) and N first-time
            # entries land in ONE rewrite — never N commits
            self._pending_cache[(layer, kernel)] = {
                k: np.asarray(v) for k, v in weights.items()}
            if layer not in self._order:
                self._order.append(layer)
            return
        self._write(self._cache_path(layer, kernel), weights)

    def read_cached(self, layer: str, kernel: str, *,
                    mmap: Optional[bool] = None) -> Dict[str, np.ndarray]:
        if self.fault_injector is not None:
            self.fault_injector.maybe_fault("store.read_cached", layer)
        try:
            if self.fmt == "super":
                if (layer, kernel) in self._pending_drop:
                    return {}
                use = self.mmap if mmap is None else mmap
                pend = self._pending_cache.get((layer, kernel))
                if pend is not None:
                    # serve the buffered entry without forcing a flush (copies
                    # under mmap=False so callers may mutate freely)
                    return ({k: np.array(v) for k, v in pend.items()}
                            if not use else dict(pend))
                sb = self._super()
                if sb is None:
                    return {}
                return sb.read_cached(layer, kernel, materialize=not use)
            return self._read(self._cache_path(layer, kernel), mmap)
        except OSError as e:
            f = classify(e, site="store.read_cached", layer=layer)
            if f is e:
                raise
            raise f from e

    # -- async submit/reap reads (repro.ioengine) ---------------------------
    @property
    def supports_async(self) -> bool:
        """True when reads can go through the async I/O engine (the npy
        legacy layout stays sync — its N-tiny-files shape is the thing
        the benchmarks keep it around to demonstrate)."""
        return self.fmt in ("super", "bundle")

    def submit_read_raw(self, engine, layer: str):
        """Submit ``layer``'s raw extents to the async engine; returns a
        pending-read handle (``wait()``/``nbytes()``/``release()``).  The
        same fault-injection site as ``read_raw`` is armed at submit, and
        the engine arms ``ioengine.submit``/``ioengine.reap``, so chaos
        runs cover the async path without new wiring."""
        if self.fault_injector is not None:
            self.fault_injector.maybe_fault("store.read_raw", layer)
        try:
            if self.fmt == "super":
                sb = self._super()
                pend = (sb.submit_read(engine, layer,
                                       injector=self.fault_injector)
                        if sb is not None else None)
                return pend if pend is not None else _ImmediateRead({})
            if self.fmt == "bundle":
                p = self._raw_path(layer)
                if not p.exists():
                    return _ImmediateRead({})
                return _PendingBundleRead(self, p, engine,
                                          self.fault_injector,
                                          key=layer).submit()
            return _ImmediateRead(self._read(self._raw_path(layer), False))
        except OSError as e:
            f = classify(e, site="store.read_raw", layer=layer)
            if f is e:
                raise
            raise f from e

    def submit_read_cached(self, engine, layer: str, kernel: str):
        """Async counterpart of ``read_cached``; buffered (not-yet-flushed)
        entries are served immediately, a dropped-pending entry reads as
        absent, and a reaped extent failing its CRC audit drops exactly
        like the sync path (``wait()`` returns ``{}``)."""
        if self.fault_injector is not None:
            self.fault_injector.maybe_fault("store.read_cached", layer)
        try:
            if self.fmt == "super":
                if (layer, kernel) in self._pending_drop:
                    return _ImmediateRead({})
                pend_w = self._pending_cache.get((layer, kernel))
                if pend_w is not None:
                    return _ImmediateRead(
                        {k: np.array(v) for k, v in pend_w.items()})
                sb = self._super()
                pend = (sb.submit_read(engine, layer, kernel=kernel,
                                       injector=self.fault_injector)
                        if sb is not None else None)
                if pend is None:
                    return _ImmediateRead({})
                pend.on_drop = self._harvest_drops
                return pend
            if self.fmt == "bundle":
                p = self._cache_path(layer, kernel)
                if not p.exists():
                    return _ImmediateRead({})
                return _PendingBundleRead(self, p, engine,
                                          self.fault_injector,
                                          key=f"{layer}@{kernel}").submit()
            return _ImmediateRead(
                self._read(self._cache_path(layer, kernel), False))
        except OSError as e:
            f = classify(e, site="store.read_cached", layer=layer)
            if f is e:
                raise
            raise f from e

    def audit_cached(self, layer: str, kernel: str) -> bool:
        """Run the lazy CRC audit on a cache entry NOW, covering the
        zero-copy mmap path (which normally serves views unverified). The
        runtime's degradation ladder calls this before trusting a cached
        entry mid-run: a failing extent is dropped from the header
        (reported via ``dropped_entries``) and the caller transparently
        recomputes the transform from raw. Returns False exactly when the
        entry just failed its audit; True when it verifies, is still
        buffered, is absent (``read_cached`` returns ``{}`` anyway), or
        auditing is off (non-super format / ``verify="never"``)."""
        if self.fmt != "super" or self.verify == "never":
            return True
        if (layer, kernel) in self._pending_cache:
            return True
        if (layer, kernel) in self._pending_drop:
            return False
        sb = self._super()
        if sb is None or not sb.has_cached(layer, kernel):
            return True
        ok = sb._verify_cached(layer, kernel)
        if not ok:
            self._harvest_drops()
        return ok

    def _harvest_drops(self) -> None:
        """Sync the reader's drop reports into ``dropped_entries`` NOW, so
        a repair event can cite the reason without waiting for the reader
        to reopen (audit failures and async CRC drops both land here)."""
        sb = self._reader
        if sb is None:
            return
        self.dropped_entries += sb.dropped[self._reader_seen:]
        self._reader_seen = len(sb.dropped)

    def has_cached(self, layer: str, kernel: str) -> bool:
        if self.fmt == "super":
            if (layer, kernel) in self._pending_cache:
                return True
            if (layer, kernel) in self._pending_drop:
                return False
            if not self._super_path.exists():
                return False
            sb = self._super()
            return sb is not None and sb.has_cached(layer, kernel)
        return self._cache_path(layer, kernel).exists()

    def drop_cached(self, layer: str, kernel: str):
        if self.fmt == "super":
            self._quiesce_maintenance()
            self._pending_cache.pop((layer, kernel), None)
            if self._super_dirty():
                self._pending_drop.add((layer, kernel))
            elif self._super_path.exists():
                self._invalidate_reader()
                drop_cache_entry(self._super_path, layer, kernel)
            return
        p = self._cache_path(layer, kernel)
        if p.is_dir():
            shutil.rmtree(p)
        elif p.exists():
            p.unlink()

    # -- storage accounting (real on-disk footprint) ------------------------
    def cache_bytes(self) -> int:
        if self.fmt == "super":
            sb = self._super(flush_all=True)
            return sb.cache_disk_bytes() if sb is not None else 0
        return sum(p.stat().st_size
                   for p in (self.root / "cache").rglob("*") if p.is_file())

    def model_bytes(self) -> int:
        # for super, model + cache sums to the container's real file size
        # (header/slack/padding are attributed to the model side)
        if self.fmt == "super":
            sb = self._super(flush_all=True)
            if sb is None:
                return 0
            return sb.file_size() - sb.cache_disk_bytes()
        return sum(p.stat().st_size
                   for p in (self.root / "raw").rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# training-checkpoint pytrees
# ---------------------------------------------------------------------------
def save_pytree(root: Path, tree: Any) -> None:
    """Write ``tree`` (nested dicts and NamedTuples of tensors or numpy
    arrays) under ``root``: ``leaf_{i:05d}.npy`` per leaf in JAX's leaf
    order, bf16 stored widened to f32 with the dtype recorded as
    "bfloat16" (``.npy`` has no bf16), and ``index.json`` with
    ``leaves`` [{key (JAX's keystr), file, dtype}] and the port's own
    ``treedef`` string. Any other void-kind dtype raises ``TypeError``."""
    from repro_torch import pytree

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    index = []
    for i, (key, leaf) in enumerate(pytree.flatten_with_path(tree)):
        fname = f"leaf_{i:05d}.npy"
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        else:
            leaf = np.asarray(leaf)
            if bf16.is_bf16(leaf):
                leaf = bf16.to_tensor(np.ascontiguousarray(leaf))
            elif leaf.dtype.kind == "V":
                # a structured dtype (or another extension type) would be
                # widened or mislabeled silently
                raise TypeError(
                    f"save_pytree: unsupported dtype {leaf.dtype} at {key!r}"
                    f" — only numpy-native dtypes and bfloat16 round-trip")
        if isinstance(leaf, torch.Tensor):
            arr = leaf.to(torch.float32 if leaf.dtype == torch.bfloat16
                          else leaf.dtype).numpy()
            dtype_str = bf16.dtype_name(leaf)
        else:
            arr, dtype_str = leaf, str(leaf.dtype)
        np.save(root / fname, arr, allow_pickle=False)
        index.append({"key": key, "file": fname, "dtype": dtype_str})
    (root / "index.json").write_text(json.dumps(
        {"leaves": index, "treedef": pytree.treedef_str(tree)}, indent=1))


def load_pytree(root: Path, like: Any) -> Any:
    """The tree ``save_pytree`` (of either package) wrote under ``root``,
    in ``like``'s structure, each leaf a tensor in the dtype and on the
    device of ``like``'s leaf (a bf16 leaf stored widened comes back
    exact)."""
    from repro_torch import pytree

    root = Path(root)
    flat = pytree.leaves(like)
    idx = json.loads((root / "index.json").read_text())["leaves"]
    if len(idx) != len(flat):
        raise ValueError(f"load_pytree: {root} holds {len(idx)} leaves, the "
                         f"tree {len(flat)}")
    out = []
    for e, f in zip(idx, flat):
        t = torch.from_numpy(np.load(root / e["file"], allow_pickle=False))
        out.append(t.to(device=f.device, dtype=f.dtype))
    return pytree.unflatten(like, out)
