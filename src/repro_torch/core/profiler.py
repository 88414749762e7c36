"""Per-operation profiling — the measurement substrate of the decision stage.

The paper profiles read / transform / execute per (layer, kernel) on the real
device; we additionally split out *stage* — the host→device transfer of the
transformed weights (``core.staging.stage_weights``) that the pipeline runs
as the tail of each preparation op. With mmap-backed bundles the read op is
metadata-cheap and staging carries the byte movement, so the scheduler
needs both numbers separately.

  * `wall` numbers are real measured seconds on the running host (real disk
    reads, real transforms); execution on a CUDA device is timed with CUDA
    events around warmed launches on the profiler's own stream;
  * the big.LITTLE asymmetry is applied through a calibratable ``CoreModel``
    whose default factors follow the paper's Fig. 6 (big core ≈ 6× faster at
    execution, 2× at reads, 3.8× at transforms than a little core) — used by
    the deterministic scheduler simulation (sim mode).

Profiles are cached to JSON next to the model store, and — keyed by shape
class rather than layer name — in a persistent ``ProfileDB`` so a second
``decide()`` (or a sibling model sharing the DB file) skips profiling
entirely.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import shutil
import tempfile
import time
from dataclasses import dataclass, field, asdict, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.core.registry import Kernel, LayerSpec, OpKind
from repro_torch.core.staging import consume, stage_weights
from repro_torch.device import as_device, new_stream, on_stream, to_device


@dataclass(frozen=True)
class CoreModel:
    """Relative op-time multipliers for a little core vs a big core (Fig. 6)."""
    little_exec: float = 6.0
    little_read: float = 2.0
    little_transform: float = 3.8
    # host->device staging is DMA-bound, not core-bound: a little core
    # initiating the transfer is barely slower than a big one
    little_stage: float = 1.2
    n_big: int = 4
    n_little: int = 4
    # multithread scaling on big cores for execution (near-linear, Fig. 6)
    exec_parallel_eff: float = 0.85

    def little_factor(self, kind: OpKind) -> float:
        return {
            OpKind.READ: self.little_read,
            OpKind.TRANSFORM: self.little_transform,
            OpKind.EXECUTE: self.little_exec,
            OpKind.COMPILE: self.little_transform,
            OpKind.STAGE: self.little_stage,
        }[kind]


@dataclass
class OpProfile:
    layer: str
    kernel: str
    read_raw_s: float
    transform_s: float
    read_cached_s: float
    exec_s: float
    compile_s: float
    raw_bytes: int
    transformed_bytes: int
    # host->device transfer of the transformed weights (the pipeline's new
    # 'stage' op). Defaults to 0 so pre-split profile JSONs still load.
    stage_s: float = 0.0
    # shapes/dtypes of the TRANSFORMED weights: {name: [shape, dtype_str]}.
    # Lets the engine build meta-tensor avatars for the compile cache
    # without re-reading + re-transforming real weights per layer.
    transformed_avatars: Optional[Dict[str, Any]] = None

    def prep_s(self, use_cache: bool, *, include_stage: bool = True) -> float:
        """Full preparation time on a BIG core: read (+transform) + device
        staging. ``include_stage=False`` gives the legacy read/transform-only
        number for read-vs-stage breakdowns."""
        io = self.read_cached_s if use_cache else self.read_raw_s + self.transform_s
        return io + (self.stage_s if include_stage else 0.0)

    def to_dict(self):
        return asdict(self)


def avatars_of(weights: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-able {name: [shape, dtype_str]} description of a weight dict —
    the transformed-weight avatars ``OpProfile`` carries and the engine
    rehydrates into meta-tensor examples for the compile cache."""
    return {k: [list(np.asarray(v).shape), bf16.dtype_name(np.asarray(v))]
            for k, v in weights.items()}


def _time(fn, *args, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


class Profiler:
    """Measures one (layer, kernel) pair. Candidate transformed weights are
    written to a private *scratch* directory for cached-read timing — never
    to the model store: only ``decide()`` materializes the chosen entries
    (with ``fmt="super"`` a store write is a container rewrite, so a
    profiling pass that wrote every candidate would rewrite the whole model
    file once per candidate)."""

    def __init__(self, store, repeats: int = 3, cold_reads: bool = True,
                 device="cuda"):
        self.store = store  # checkpoint.LayerStore
        self.repeats = repeats
        self.cold_reads = cold_reads
        self.device = as_device(device)
        self._stream = None  # exec-timing stream (CUDA only), made lazily
        self._scratch: Optional[Path] = None
        self.calls = 0

    @property
    def scratch(self) -> Path:
        if self._scratch is None:
            self._scratch = Path(tempfile.mkdtemp(prefix="nnv12_prof_"))
        return self._scratch

    def close(self):
        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)
            self._scratch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _time_read(self, fn) -> float:
        """Disk-read timing. With cold_reads (and privilege) the OS page
        cache is dropped first, like the paper's methodology; otherwise the
        warm-cache read time is reported."""
        from repro_torch.core.oscache import CAN_DROP, drop_page_cache

        if self.cold_reads and CAN_DROP:
            drop_page_cache()
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return _time(fn, repeats=self.repeats)

    def _time_exec(self, fn, w, x) -> Tuple[float, float]:
        """(first call incl. any kernel build, best of ``repeats`` warmed
        calls) in seconds. On a CUDA device each warmed call is bracketed
        by CUDA events on the profiler's stream."""
        if self._stream is None:
            self._stream = new_stream(self.device)
        stream = self._stream
        with on_stream(stream):
            consume(w, stream)
            t0 = time.perf_counter()
            fn(w, x)
            if stream is not None:
                stream.synchronize()
            first = time.perf_counter() - t0
            if stream is None:
                return first, _time(fn, w, x, repeats=self.repeats)
            best = float("inf")
            for _ in range(self.repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                fn(w, x)
                end.record(stream)
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
        return first, best

    def profile(
        self, spec: LayerSpec, kernel: Kernel, x: np.ndarray,
    ) -> OpProfile:
        # Reads are profiled MATERIALIZING (mmap=False) so the read term
        # keeps meaning "move the layer's bytes off the disk" — measurable
        # cold and scalable by the co-read interference factor. The runtime's
        # mmap read is lazier (its payload I/O surfaces inside transform/
        # stage on first touch), but read+transform+stage is scheduled as
        # ONE prep op, so only the total matters — and the total matches.
        def _read_raw():
            return self.store.read_raw(spec.name, mmap=False)

        self.calls += 1
        # pin the store's one-off lazy CRC audit outside the timed region —
        # it must not inflate the profiled read cost
        warm = getattr(self.store, "warm_verify", None)
        if warm is not None:
            warm([spec.name])
        raw = self.store.read_raw(spec.name)
        t_read = self._time_read(_read_raw)
        if spec.weight_shapes:
            from repro_torch.checkpoint.bundle import read_bundle, write_bundle

            t_transform = _time(lambda: kernel.transform(raw, spec), repeats=self.repeats)
            transformed = kernel.transform(raw, spec)
            # cached-read timing goes through a scratch bundle, NOT the
            # model store — decide() drops the losers, and a super-bundle
            # store would pay one container rewrite per candidate
            scratch = self.scratch / f"{spec.name.replace('/', '_')}.{kernel.name}.bundle"
            write_bundle(scratch, transformed)
            try:
                t_read_cached = self._time_read(
                    lambda: read_bundle(scratch, mmap=False))
            finally:
                scratch.unlink(missing_ok=True)
            tbytes = sum(v.nbytes for v in transformed.values())
            rbytes = sum(v.nbytes for v in raw.values())
        else:
            t_transform, t_read_cached, tbytes, rbytes = 0.0, 0.0, 0, 0
            transformed = raw
        # stage: host->device transfer of the transformed weights — the
        # pipeline runs this as part of prep, so the scheduler must see it
        # split out from the (now metadata-cheap, mmap-backed) read
        if transformed:
            t_stage = _time(lambda: stage_weights(transformed, self.device),
                            repeats=self.repeats)
        else:
            t_stage = 0.0
        wt = stage_weights(transformed, self.device)
        xt = to_device(x, self.device)
        t_compile_and_first, t_exec = self._time_exec(
            lambda w, x: kernel.execute(w, x, spec), wt, xt)
        return OpProfile(
            layer=spec.name, kernel=kernel.name,
            read_raw_s=t_read, transform_s=t_transform,
            read_cached_s=t_read_cached, exec_s=t_exec,
            compile_s=max(t_compile_and_first - t_exec, 0.0),
            raw_bytes=rbytes, transformed_bytes=tbytes,
            stage_s=t_stage,
            transformed_avatars=avatars_of(transformed),
        )


def measure_read_interference(store, layer_names, n_threads: int = 3) -> float:
    """§3.2: co-running read operations interfere through shared disk
    bandwidth. Measures the real slowdown factor on this host: wall time of
    n_threads concurrent cold reads of different layers vs the same reads
    serial. Returns per-op slowdown ≥ 1 (1.0 = no interference)."""
    import threading

    from repro_torch.core.oscache import CAN_DROP, drop_page_cache

    names = [n for n in layer_names if store.raw_bytes(n) > 0][: n_threads * 2]
    if len(names) < 2:
        return 1.0
    names = names[:n_threads]

    # force materializing reads: with mmap-backed bundles the default read is
    # metadata-only and would measure nothing about disk bandwidth
    def _read(n):
        try:
            store.read_raw(n, mmap=False)
        except TypeError:  # stores without an mmap switch
            store.read_raw(n)

    # land the store's one-off lazy CRC audit now so neither timed pass
    # pays it
    warm = getattr(store, "warm_verify", None)
    if warm is not None:
        warm(names)

    if CAN_DROP:
        drop_page_cache()
    t0 = time.perf_counter()
    for n in names:
        _read(n)
    serial = time.perf_counter() - t0

    if CAN_DROP:
        drop_page_cache()
    threads = [threading.Thread(target=_read, args=(n,))
               for n in names]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    concurrent = time.perf_counter() - t0
    # perfect overlap -> concurrent == serial/n; full serialization ->
    # concurrent == serial. slowdown per op = concurrent * n / serial.
    return max(1.0, concurrent * len(names) / max(serial, 1e-9))


def save_profiles(path: Path, profiles: Dict[str, List[OpProfile]]):
    from repro_torch.checkpoint import atomic_write_text

    out = {k: [p.to_dict() for p in v] for k, v in profiles.items()}
    atomic_write_text(Path(path), json.dumps(out, indent=1))


def load_profiles(path: Path) -> Optional[Dict[str, List[OpProfile]]]:
    if not path.exists():
        return None
    raw = json.loads(path.read_text())
    return {k: [OpProfile(**d) for d in v] for k, v in raw.items()}


class SyntheticProfiler(Profiler):
    """Deterministic profiles derived from shapes alone — no disk reads, no
    kernel launches, no clocks. Costs are a pure function of (shape class,
    kernel), so byte-identical layers get bit-identical numbers: the
    substrate for the shared-vs-per-layer plan-equivalence gates in tests
    and for plan parity with the JAX package."""

    GB_S = 1.0e9       # synthetic disk bandwidth
    # compute is much faster than disk on the modeled edge device (cold
    # inference is I/O-bound — §2): exec/dequant run at this bandwidth, so
    # Algorithm 1's read-vs-exec trade deterministically favors entries
    # that shrink the cold read unless their exec surcharge is outsized
    EXEC_GB_S = 24.0e9

    def profile(self, spec: LayerSpec, kernel: Kernel, x: np.ndarray) -> OpProfile:
        self.calls += 1
        raw = {k: np.zeros(s, np.float32)
               for k, s in spec.weight_shapes.items()}
        transformed = kernel.transform(raw, spec) if spec.weight_shapes else {}
        rbytes = sum(v.nbytes for v in raw.values())
        tbytes = sum(np.asarray(v).nbytes for v in transformed.values())
        # per-kernel multipliers from a stable hash — kernels trade off
        # transform vs execute like real ones, deterministically
        h = int(hashlib.sha1(kernel.name.encode()).hexdigest()[:8], 16)
        t_mult = 0.5 + (h % 997) / 997.0
        e_mult = 0.5 + ((h >> 8) % 997) / 997.0
        xbytes = int(np.asarray(x).nbytes)
        # exec cost is based on LOGICAL bytes (a FLOP proxy): a compressed
        # cache entry (bf16, int8, int4) shrinks the read, not the matmul.
        # Quantized transforms additionally pay a dequant surcharge — smaller
        # reads buy nonzero extra execute time, which is exactly the trade
        # Algorithm 1 must see deterministically
        from repro_torch import quant

        ebytes = max(tbytes, rbytes)
        dequant_s = 0.0
        if transformed and quant.is_quantized(transformed):
            ebytes = max(quant.logical_nbytes(transformed), rbytes)
            # one extra compute-bandwidth pass over the quantized payload:
            # the fused kernels unpack/scale in VMEM with the per-channel
            # scale factored out of the K loop (repro_torch.kernels.quant)
            dequant_s = tbytes / self.EXEC_GB_S
        return OpProfile(
            layer=spec.name, kernel=kernel.name,
            read_raw_s=rbytes / self.GB_S + 1e-5,
            transform_s=t_mult * tbytes / self.GB_S,
            read_cached_s=tbytes / self.GB_S + 1e-5,
            exec_s=e_mult * (ebytes + xbytes) / self.EXEC_GB_S
                   + dequant_s + 1e-6,
            compile_s=1e-3,
            raw_bytes=rbytes, transformed_bytes=tbytes,
            stage_s=tbytes / (4 * self.GB_S),
            transformed_avatars=avatars_of(transformed),
        )


# ---------------------------------------------------------------------------
# persistent profile DB — shape-class keyed, host-scoped
# ---------------------------------------------------------------------------
def host_fingerprint() -> str:
    """Identity of the measuring host: profiles are wall-clock measurements,
    so entries from a different machine/CPU count/torch or CUDA build/GPU
    must miss."""
    from repro_torch.core.compile_cache import _version_tag

    gpu = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "-"
    parts = [platform.system(), platform.machine(),
             str(os.cpu_count()), _version_tag(), gpu]
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


class ProfileDB:
    """Persistent (shape-class × kernel) -> OpProfile store.

    Lives as one JSON file (by default next to the model store), keyed by
    the canonical shape-class hash (``registry.shape_class_key``) + kernel
    name, scoped by ``host_fingerprint()``. A second ``decide()`` on the
    same model — or a first ``decide()`` on a sibling model whose layers
    fall into already-measured shape classes — performs zero
    ``Profiler.profile`` calls. ``force_reprofile`` bypasses reads and
    overwrites on save."""

    VERSION = 2

    def __init__(self, path: Path):
        self.path = Path(path)
        self.host = host_fingerprint()
        # all hosts' entries are kept side by side: a shared DB file (two
        # machines, or two torch builds on one machine) must not clobber the
        # other host's profiles on save
        self._hosts: Dict[str, Dict[str, Dict[str, dict]]] = {}
        self.entries: Dict[str, Dict[str, dict]] = {}
        # sibling index (batch-agnostic fan-out): sibling_key -> list of
        # exact shape classes profiled under it, per host. Approximate
        # lookups resolve through it AFTER the exact key misses.
        self._host_siblings: Dict[str, Dict[str, List[str]]] = {}
        self.siblings: Dict[str, List[str]] = {}
        # host-fingerprint drift: when this host has NO entries but another
        # fingerprint in the same file does (same machine after a torch
        # upgrade / CPU-count change), that host's entries are kept as
        # STALE fallbacks — ``get`` serves them (so the cold path never
        # pays in-line re-profiling for a fingerprint bump) and records the
        # key in ``self.stale`` so background re-profiling (the server's
        # idle tick → ``ColdEngine.reprofile_stale``) can refresh them off
        # the request path. ``put`` un-stales a key.
        self._stale_entries: Dict[str, Dict[str, dict]] = {}
        self.stale: set = set()          # (shape_class, kernel) served stale
        self.drifted_from: Optional[str] = None
        self.stats = {"hits": 0, "misses": 0, "approx_hits": 0,
                      "stale_hits": 0}
        self._dirty = False
        self._load()

    def _load(self):
        if not self.path.exists():
            return
        try:
            raw = json.loads(self.path.read_text())
        except Exception:
            return  # torn/corrupt DB: reprofile
        if raw.get("version") != self.VERSION:
            return  # different schema: everything misses cleanly
        self._hosts = raw.get("hosts", {})
        self.entries = self._hosts.get(self.host, {})
        # optional key: DB files from before the sibling index load fine
        self._host_siblings = raw.get("siblings", {})
        self.siblings = self._host_siblings.get(self.host, {})
        if not self.entries:
            # fingerprint drift: adopt the richest other host's entries as
            # stale estimates (measurements of the right shapes on almost
            # this machine beat re-profiling on the cold path)
            donors = [h for h in self._hosts if h != self.host
                      and self._hosts[h]]
            if donors:
                self.drifted_from = max(
                    donors, key=lambda h: sum(len(v) for v
                                              in self._hosts[h].values()))
                self._stale_entries = self._hosts[self.drifted_from]

    def get(self, shape_class: str, kernel: str, *,
            sibling_key: Optional[str] = None,
            approx: bool = False) -> Optional[OpProfile]:
        """Exact (shape-class, kernel) lookup; with ``approx=True`` and a
        ``sibling_key``, a miss falls through to any already-profiled class
        that differs only in the batch dim (``shape_class_sibling_key``).
        Exact entries always win — the approximate rung only spares a
        profiling call when nothing exact exists, and its per-op costs are
        estimates for candidate ranking, never correctness inputs."""
        d = self.entries.get(shape_class, {}).get(kernel)
        if d is not None:
            self.stats["hits"] += 1
            return OpProfile(**d)
        # stale (drifted-host) exact entry: same shapes, almost this host —
        # served so decide() stays off the profiler, marked for background
        # refresh. Checked before the approx rung: an exact-shape stale
        # measurement beats a fresh sibling estimate.
        d = self._stale_entries.get(shape_class, {}).get(kernel)
        if d is not None:
            self.stats["stale_hits"] += 1
            self.stale.add((shape_class, kernel))
            return OpProfile(**d)
        if approx and sibling_key is not None:
            for sc in self.siblings.get(sibling_key, ()):
                if sc == shape_class:
                    continue
                d = self.entries.get(sc, {}).get(kernel)
                if d is not None:
                    self.stats["approx_hits"] += 1
                    return OpProfile(**d)
        self.stats["misses"] += 1
        return None

    def put(self, shape_class: str, kernel: str, profile: OpProfile, *,
            sibling_key: Optional[str] = None):
        self.entries.setdefault(shape_class, {})[kernel] = asdict(profile)
        # a fresh measurement supersedes the drifted-host fallback
        self.stale.discard((shape_class, kernel))
        if sibling_key is not None:
            sibs = self.siblings.setdefault(sibling_key, [])
            if shape_class not in sibs:
                sibs.append(shape_class)
        self._dirty = True

    def stale_pending(self) -> List[tuple]:
        """(shape_class, kernel) keys served stale and not yet re-measured —
        the background re-profiling work list."""
        return sorted(self.stale)

    def save(self):
        from repro_torch.checkpoint import atomic_write_text

        if not self._dirty:
            return
        self._hosts[self.host] = self.entries
        if self.siblings:
            self._host_siblings[self.host] = self.siblings
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # durable commit: the DB is the cross-decide()/cross-model profile
        # substrate — a torn file would silently force a full reprofile
        atomic_write_text(self.path, json.dumps({
            "version": self.VERSION, "hosts": self._hosts,
            "siblings": self._host_siblings}, indent=1),
            durable=True)
        self._dirty = False
