"""Pluggable async I/O engine for the cold prep path.

Cold inference is I/O bound: the prep pipeline must keep the disk at
queue depth while big cores transform (NNV12 §3.1-§3.3).  The executor's
``read`` task used to issue one synchronous mmap page-fault read at a
time, so the device never saw more than depth 1.  This module owns the
asynchrony: reads become *submit/reap* pairs against one of three
backends, selected at probe time exactly like the CRC-32C backends
(candidates are self-checked against known bytes before being trusted,
``REPRO_IO_ENGINE`` forces one):

  uring   raw io_uring via ctypes syscalls (``io_uring_setup``/
          ``io_uring_enter``, mmap'd SQ/CQ rings, ``IORING_OP_READ``) —
          true kernel async, no thread per request; requires a kernel
          that exposes the syscalls (probe falls back on EPERM/ENOSYS,
          e.g. under seccomp).
  aio     portable thread-pool fallback: N workers draining a queue of
          ``os.preadv`` requests — async to the caller, sync inside each
          worker.
  sync    ``os.pread`` inline at submit time.  The forced-sync override
          and the reference arm: every byte the async backends return is
          gated bit-identical against it in ``benchmarks/io_formats.py``.

Reads land in buffers from a :class:`PinnedBufferPool` — pre-registered
anonymous slabs, ``mlock``-pinned where the RLIMIT allows (recorded, not
required) and recycled by size class.  Reaped views are returned
**read-only** so the existing staging contract applies unchanged:
``stage_weights`` materializes read-only views into anonymous memory
before ``torch.from_numpy``, which is exactly what makes buffer recycling
safe — a recycled slab can never alias a device-resident weight.  Pool
buffers are released back per *job* (the executor holds task values until
the job completes for retry idempotency, so views stay valid across
bounded transient retries).

The engine also owns the live byte counters (`bytes_in_flight`) that
drive admission control: ``submit`` blocks while a configured
``max_bytes_in_flight`` budget is exceeded (a single oversized request is
admitted alone, so the gate can never wedge), and idle callbacks fire on
the in-flight -> 0 transition — ``ColdServer`` uses them for bounded
incremental compaction ticks.

Fault injection: ``submit``/``reap`` arm the deterministic injector at
sites ``ioengine.submit`` and ``ioengine.reap`` (typed ``ReadFault``,
bounded retries by the executor's existing policy), alongside the
store-level ``store.read_raw``/``store.read_cached`` sites, so the chaos
and crash gates run unchanged with the engine active.

Staging has the same split: :class:`StageEngine` routes the ``stage`` op
through a dedicated DMA queue thread when a CUDA device is present
(host->device copies issue from CUDA page-locked bounce slabs on a
dedicated copy stream, serialized so they never contend with the exec
chain's own transfers) and falls back to the inline host path
(``stage_weights``) for CPU tensors, where ``torch.from_numpy`` aliases
host memory and a bounce buffer would be aliasing hazard, not a win.
``REPRO_STAGE_ENGINE`` overrides.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import mmap
import os
import queue
import struct
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.faults import ReadFault, StageFault, classify

__all__ = [
    "IOEngine", "ReadTicket", "ReadAbandoned", "TransferCharge",
    "PinnedBufferPool", "PinnedBuffer", "StageEngine", "get_io_engine",
    "reset_io_engine", "get_stage_engine", "reset_stage_engine",
    "available_backends",
]


class ReadAbandoned(Exception):
    """The waiter's read was abandoned mid-wait (e.g. a warm-state fetch
    won the race for its layer). Control-flow signal, not a fault: the
    caller bails out of the chain instead of retrying."""

ENV_ENGINE = "REPRO_IO_ENGINE"
ENV_STAGE = "REPRO_STAGE_ENGINE"

# ---------------------------------------------------------------------------
# pinned buffer pool
# ---------------------------------------------------------------------------

_PAGE = mmap.PAGESIZE
_MIN_CLASS = 4096

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    return _libc


def _try_mlock(addr: int, nbytes: int) -> bool:
    try:
        libc = _get_libc()
        if libc.mlock(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes)) == 0:
            return True
    except Exception:
        pass
    return False


def _try_munlock(addr: int, nbytes: int) -> None:
    try:
        _get_libc().munlock(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes))
    except Exception:
        pass


class PinnedBuffer:
    """One slab from the pool: a writable uint8 array plus its address.

    ``view(nbytes)`` hands out a **read-only** view of the filled prefix;
    ``release()`` returns the slab to its pool (caller contract: only
    after every view into it has been consumed or copied).
    """

    __slots__ = ("pool", "arr", "capacity", "addr", "pinned", "pooled",
                 "_released")

    def __init__(self, pool: "PinnedBufferPool", arr: np.ndarray,
                 pinned: bool, pooled: bool):
        self.pool = pool
        self.arr = arr
        self.capacity = arr.nbytes
        self.addr = arr.ctypes.data
        self.pinned = pinned
        self.pooled = pooled
        self._released = False

    def view(self, nbytes: int) -> np.ndarray:
        v = self.arr[:nbytes].view()
        v.flags.writeable = False
        return v

    def release(self) -> None:
        self.pool._release(self)


class PinnedBufferPool:
    """Size-class recycling pool of mlock-pinned anonymous slabs.

    Slabs are pre-registered once (allocated + pinned) and reused across
    reads; beyond ``max_bytes`` of retained slabs, extra requests get
    one-shot unpooled buffers so a burst can never pin unbounded memory.
    mlock failures (RLIMIT_MEMLOCK, containers) degrade to unpinned slabs
    and are counted, never raised.
    """

    def __init__(self, max_bytes: int = 64 << 20, pin: bool = True,
                 prealloc_bytes: int = 0):
        self.max_bytes = int(max_bytes)
        self.pin = pin
        self._lock = threading.Lock()
        self._free: Dict[int, List[PinnedBuffer]] = {}
        self._retained = 0          # bytes held by the pool (free + leased)
        self.stats = {"acquires": 0, "reuses": 0, "allocs": 0,
                      "overflow_allocs": 0, "mlock_failures": 0,
                      "pinned_bytes": 0, "retained_bytes": 0}
        if prealloc_bytes > 0:
            # pre-register a working set so first reads never pay
            # allocate+mlock on the critical path
            cls = self._size_class(256 << 10)
            bufs = []
            while prealloc_bytes > 0:
                bufs.append(self.acquire(cls))
                prealloc_bytes -= cls
            for b in bufs:
                b.release()

    @staticmethod
    def _size_class(nbytes: int) -> int:
        c = _MIN_CLASS
        while c < nbytes:
            c <<= 1
        return c

    def acquire(self, nbytes: int) -> PinnedBuffer:
        nbytes = max(1, int(nbytes))
        cls = self._size_class(nbytes)
        with self._lock:
            self.stats["acquires"] += 1
            free = self._free.get(cls)
            if free:
                buf = free.pop()
                buf._released = False
                self.stats["reuses"] += 1
                return buf  # noqa: released flag cleared under the lock
            pooled = self._retained + cls <= self.max_bytes
            if pooled:
                self._retained += cls
                self.stats["retained_bytes"] = self._retained
                self.stats["allocs"] += 1
            else:
                self.stats["overflow_allocs"] += 1
        arr = np.empty(cls, dtype=np.uint8)
        pinned = False
        if self.pin and pooled:
            pinned = _try_mlock(arr.ctypes.data, cls)
            with self._lock:
                if pinned:
                    self.stats["pinned_bytes"] += cls
                else:
                    self.stats["mlock_failures"] += 1
        return PinnedBuffer(self, arr, pinned=pinned, pooled=pooled)

    def _release(self, buf: PinnedBuffer) -> None:
        # idempotent under the pool lock: release() may race between a
        # caller abandoning a ticket and the backend finishing it
        with self._lock:
            if buf._released:
                return
            buf._released = True
            if buf.pooled:
                self._free.setdefault(buf.capacity, []).append(buf)
            # overflow slabs just drop to the allocator

    def close(self) -> None:
        with self._lock:
            free, self._free = self._free, {}
            self._retained = 0
            self.stats["retained_bytes"] = 0
        for bufs in free.values():
            for b in bufs:
                if b.pinned:
                    _try_munlock(b.addr, b.capacity)


# ---------------------------------------------------------------------------
# requests / tickets
# ---------------------------------------------------------------------------

class _Request:
    __slots__ = ("fd", "offset", "nbytes", "buf", "key", "event", "error",
                 "engine", "token", "abandoned", "ready_at")

    def __init__(self, engine: "IOEngine", fd: int, offset: int, nbytes: int,
                 buf: PinnedBuffer, key: Optional[str]):
        self.engine = engine
        self.fd = fd
        self.offset = offset
        self.nbytes = nbytes
        self.buf = buf
        self.key = key
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.token = 0
        self.abandoned = False
        self.ready_at = 0.0    # disk-emulation pacing (sim_read_bytes_per_s)

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.engine._on_complete(self)
        self.event.set()
        if self.abandoned:
            self.buf.release()  # idempotent; see PinnedBufferPool._release


def _read_fully(req: _Request) -> Optional[BaseException]:
    """Blocking pread loop into the request's buffer (aio/sync backends,
    and the short-read top-up path for uring)."""
    return _fill(req, 0)


def _fill(req: _Request, got: int) -> Optional[BaseException]:
    mv = memoryview(req.buf.arr)
    try:
        while got < req.nbytes:
            n = os.preadv(req.fd, [mv[got:req.nbytes]], req.offset + got)
            if n == 0:
                return OSError(
                    f"short read: wanted {req.nbytes}B at offset "
                    f"{req.offset}, got {got}B (EOF)")
            got += n
    except OSError as e:
        return e
    return None


class ReadTicket:
    """Handle for one in-flight read.  ``wait()`` returns a **read-only**
    uint8 view of the reaped bytes; ``release()`` recycles the buffer
    (call only once every view has been consumed or copied — the executor
    does this per job)."""

    __slots__ = ("_req", "_injector")

    def __init__(self, req: _Request, injector=None):
        self._req = req
        self._injector = injector

    @property
    def key(self) -> Optional[str]:
        return self._req.key

    @property
    def nbytes(self) -> int:
        return self._req.nbytes

    def done(self) -> bool:
        return self._req.event.is_set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._injector is not None:
            self._injector.maybe_fault("ioengine.reap", self._req.key)
        if not self._req.event.wait(timeout):
            raise TimeoutError(
                f"ioengine read {self._req.key!r} not complete "
                f"after {timeout}s")
        if self._req.error is not None:
            err = self._req.error
            raise ReadFault(
                f"async read failed ({self._req.key!r}, "
                f"{self._req.nbytes}B @ {self._req.offset}): {err}") from err
        if self._req.ready_at:
            # edge-disk emulation: the bytes are here, but a slow flash
            # device would not have served them yet — pace the reap to the
            # simulated device's shared bandwidth. Sliced: a read already
            # issued to a real device cannot be recalled, but the EMULATED
            # remainder of its service time can — an abandoned race-loser
            # frees its pool slot now instead of sleeping out the device
            while True:
                if self._req.abandoned:
                    raise ReadAbandoned(
                        f"read {self._req.key!r} abandoned mid-pace")
                delay = self._req.ready_at - time.monotonic()
                if delay <= 0:
                    break
                time.sleep(min(delay, 0.002))
        return self._req.buf.view(self._req.nbytes)

    def release(self) -> None:
        self._req.buf.release()

    def interrupt(self) -> None:
        """Flag the read abandoned WITHOUT touching its buffer: a waiter
        parked in the emulated-disk pacing loop raises ``ReadAbandoned``
        (and its own cleanup releases the buffer); a waiter already past
        pacing completes normally. Safe to call from another thread —
        unlike ``abandon()``, this can never recycle a buffer someone is
        still reading."""
        self._req.abandoned = True

    def abandon(self) -> None:
        """Give up on this read: recycle the buffer now if the request is
        complete, else the moment the backend finishes it — never while
        the kernel may still be writing into it."""
        req = self._req
        req.abandoned = True
        if req.event.is_set():
            req.buf.release()


class TransferCharge:
    """One peer-transfer byte charge against the engine's admission budget.

    Peer warm-state fetches (``executor/warmstate.py``) read no local fd,
    but their payloads still land in pinned pool slabs and still count
    against ``max_bytes_in_flight`` — the budget is a statement about host
    memory pressure during prep, not about the disk specifically.  The
    charge is taken at receive time and held until the payload has been
    copied out (CRC-checked and materialized), then ``release()`` returns
    the bytes to the budget and the slab to the pool.  Release is
    idempotent, mirroring the ticket/abandon contract above, because a
    lost race may release from both the fetch path and the job-done
    cleanup."""

    __slots__ = ("engine", "buf", "nbytes", "key", "_released")

    def __init__(self, engine: "IOEngine", buf: PinnedBuffer, nbytes: int,
                 key: Optional[str]):
        self.engine = engine
        self.buf = buf
        self.nbytes = nbytes
        self.key = key
        self._released = False

    def view(self, nbytes: Optional[int] = None) -> np.ndarray:
        return self.buf.view(self.nbytes if nbytes is None else nbytes)

    def release(self) -> None:
        with self.engine._cond:
            if self._released:
                return
            self._released = True
        self.engine._on_transfer_done(self)
        self.buf.release()


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class SyncBackend:
    """``os.pread`` inline at submit: depth-1 reference implementation and
    the ``REPRO_IO_ENGINE=sync`` forced override."""

    name = "sync"

    def submit(self, req: _Request) -> None:
        req.finish(_read_fully(req))

    def close(self) -> None:
        pass


class AioBackend:
    """Portable async fallback: N worker threads draining a queue of
    ``os.preadv`` requests.  Async to the submitter, sync per worker —
    depth is bounded by the worker count times one outstanding syscall."""

    name = "aio"

    def __init__(self, workers: int = 4):
        if not hasattr(os, "preadv"):
            raise RuntimeError("os.preadv unavailable")
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._threads = []
        for i in range(max(1, workers)):
            t = threading.Thread(target=self._worker,
                                 name=f"repro-aio-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            req.finish(_read_fully(req))

    def submit(self, req: _Request) -> None:
        self._q.put(req)

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []


# -- raw io_uring via ctypes -------------------------------------------------

_NR_IO_URING_SETUP = 425
_NR_IO_URING_ENTER = 426
_IORING_OFF_SQ_RING = 0
_IORING_OFF_SQES = 0x10000000
_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1
_IORING_OP_NOP = 0
_IORING_OP_READ = 22
_SQE_SIZE = 64
_CQE_SIZE = 16


class _SqringOffsets(ctypes.Structure):
    _fields_ = [("head", ctypes.c_uint32), ("tail", ctypes.c_uint32),
                ("ring_mask", ctypes.c_uint32),
                ("ring_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32), ("dropped", ctypes.c_uint32),
                ("array", ctypes.c_uint32), ("resv1", ctypes.c_uint32),
                ("user_addr", ctypes.c_uint64)]


class _CqringOffsets(ctypes.Structure):
    _fields_ = [("head", ctypes.c_uint32), ("tail", ctypes.c_uint32),
                ("ring_mask", ctypes.c_uint32),
                ("ring_entries", ctypes.c_uint32),
                ("overflow", ctypes.c_uint32), ("cqes", ctypes.c_uint32),
                ("flags", ctypes.c_uint32), ("resv1", ctypes.c_uint32),
                ("user_addr", ctypes.c_uint64)]


class _UringParams(ctypes.Structure):
    _fields_ = [("sq_entries", ctypes.c_uint32),
                ("cq_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("sq_thread_cpu", ctypes.c_uint32),
                ("sq_thread_idle", ctypes.c_uint32),
                ("features", ctypes.c_uint32),
                ("wq_fd", ctypes.c_uint32),
                ("resv", ctypes.c_uint32 * 3),
                ("sq_off", _SqringOffsets),
                ("cq_off", _CqringOffsets)]


def _syscall(*args) -> int:
    libc = _get_libc()
    libc.syscall.restype = ctypes.c_long
    ret = libc.syscall(*[ctypes.c_long(a) if isinstance(a, int) else a
                         for a in args])
    if ret < 0:
        e = ctypes.get_errno()
        raise OSError(e, os.strerror(e))
    return ret


class UringBackend:
    """Minimal io_uring reader: setup + mmap'd SQ/CQ rings, one submitter
    lock, one reaper thread parked in ``io_uring_enter(GETEVENTS)``.

    A bounded semaphore sized to the SQ guarantees the rings can never
    overflow (the kernel sizes the CQ at 2x SQ).  Short completions are
    topped up with a synchronous pread before the request is finished, so
    callers always see all-or-error.
    """

    name = "uring"

    def __init__(self, entries: int = 64):
        params = _UringParams()
        self._ring_fd = _syscall(_NR_IO_URING_SETUP, entries,
                                 ctypes.byref(params))
        try:
            if not params.features & _IORING_FEAT_SINGLE_MMAP:
                raise RuntimeError("io_uring without SINGLE_MMAP unsupported")
            self.entries = params.sq_entries
            sq, cq = params.sq_off, params.cq_off
            ring_sz = max(sq.array + params.sq_entries * 4,
                          cq.cqes + params.cq_entries * _CQE_SIZE)
            self._ring = mmap.mmap(
                self._ring_fd, ring_sz, flags=mmap.MAP_SHARED | mmap.MAP_POPULATE,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQ_RING)
            self._sqes = mmap.mmap(
                self._ring_fd, params.sq_entries * _SQE_SIZE,
                flags=mmap.MAP_SHARED | mmap.MAP_POPULATE,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQES)
            self._sq_tail_off = sq.tail
            self._sq_mask = struct.unpack_from("<I", self._ring,
                                               sq.ring_mask)[0]
            self._sq_array_off = sq.array
            self._cq_head_off = cq.head
            self._cq_tail_off = cq.tail
            self._cq_mask = struct.unpack_from("<I", self._ring,
                                               cq.ring_mask)[0]
            self._cqes_off = cq.cqes
        except BaseException:
            os.close(self._ring_fd)
            raise
        self._sub_lock = threading.Lock()
        self._slots = threading.BoundedSemaphore(self.entries)
        self._pending: Dict[int, _Request] = {}
        self._next_token = 1
        self._closing = False
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="repro-uring-reaper", daemon=True)
        self._reaper.start()

    def _push_sqe(self, opcode: int, fd: int, offset: int, addr: int,
                  nbytes: int, token: int) -> None:
        """Write one SQE and publish it.  Caller holds ``_sub_lock`` and a
        ring slot."""
        tail = struct.unpack_from("<I", self._ring, self._sq_tail_off)[0]
        idx = tail & self._sq_mask
        sqe = struct.pack("<BBHiQQIIQ", opcode, 0, 0, fd, offset, addr,
                          nbytes, 0, token)
        self._sqes[idx * _SQE_SIZE:(idx + 1) * _SQE_SIZE] = (
            sqe + b"\0" * (_SQE_SIZE - len(sqe)))
        struct.pack_into("<I", self._ring, self._sq_array_off + idx * 4, idx)
        struct.pack_into("<I", self._ring, self._sq_tail_off,
                         (tail + 1) & 0xFFFFFFFF)
        _syscall(_NR_IO_URING_ENTER, self._ring_fd, 1, 0, 0, 0, 0)

    def submit(self, req: _Request) -> None:
        self._slots.acquire()
        try:
            with self._sub_lock:
                if self._closing:
                    raise RuntimeError("uring backend closed")
                token = self._next_token
                self._next_token += 1
                self._pending[token] = req
                req.token = token
                try:
                    self._push_sqe(_IORING_OP_READ, req.fd, req.offset,
                                   req.buf.addr, req.nbytes, token)
                except BaseException:
                    self._pending.pop(token, None)
                    raise
        except BaseException:
            self._slots.release()
            raise

    def _reap_loop(self) -> None:
        while True:
            try:
                _syscall(_NR_IO_URING_ENTER, self._ring_fd, 0, 1,
                         _IORING_ENTER_GETEVENTS, 0, 0)
            except OSError as e:
                import errno as _errno
                if e.errno == _errno.EINTR:
                    continue
                if self._closing:
                    return
                raise
            head = struct.unpack_from("<I", self._ring, self._cq_head_off)[0]
            tail = struct.unpack_from("<I", self._ring, self._cq_tail_off)[0]
            stop = False
            while head != tail:
                idx = head & self._cq_mask
                user_data, res = struct.unpack_from(
                    "<Qi", self._ring, self._cqes_off + idx * _CQE_SIZE)
                head = (head + 1) & 0xFFFFFFFF
                struct.pack_into("<I", self._ring, self._cq_head_off, head)
                if user_data == 0:  # shutdown NOP
                    stop = True
                    continue
                with self._sub_lock:
                    req = self._pending.pop(user_data, None)
                self._slots.release()
                if req is None:
                    continue
                if res < 0:
                    req.finish(OSError(-res, os.strerror(-res)))
                elif res < req.nbytes:
                    # regular-file short completion: top up synchronously
                    req.finish(_fill(req, res))
                else:
                    req.finish(None)
            if stop and not self._pending:
                return

    def close(self) -> None:
        with self._sub_lock:
            if self._closing:
                return
            self._closing = True
        try:
            self._slots.acquire()
            with self._sub_lock:
                self._push_sqe(_IORING_OP_NOP, -1, 0, 0, 0, 0)
        except Exception:
            pass
        self._reaper.join(timeout=5.0)
        self._sqes.close()
        self._ring.close()
        os.close(self._ring_fd)


# ---------------------------------------------------------------------------
# engine facade
# ---------------------------------------------------------------------------

_BACKENDS = {"uring": UringBackend, "aio": AioBackend, "sync": SyncBackend}
_PROBE_ORDER = ("uring", "aio", "sync")


def _self_check(backend, pool: PinnedBufferPool) -> None:
    """Trust no backend before it reproduces known bytes: sequential,
    offset, and unaligned-length reads against a temp file (the CRC
    backends set this precedent)."""
    data = (np.arange(192 * 1024, dtype=np.int64) % 251).astype(np.uint8)
    fd = None
    path = None
    try:
        f, path = tempfile.mkstemp(prefix="repro_ioengine_probe_")
        os.write(f, data.tobytes())
        os.close(f)
        fd = os.open(path, os.O_RDONLY)
        cases = [(0, len(data)), (4096, 64 * 1024), (100_003, 31_337)]
        reqs = []
        for off, n in cases:
            req = _Request(_NullEngine, fd, off, n, pool.acquire(n), "probe")
            backend.submit(req)
            reqs.append((off, n, req))
        for off, n, req in reqs:
            if not req.event.wait(5.0):
                raise RuntimeError(f"{backend.name} probe timed out")
            if req.error is not None:
                raise req.error
            if not np.array_equal(req.buf.view(n), data[off:off + n]):
                raise RuntimeError(
                    f"{backend.name} probe returned wrong bytes "
                    f"({n}B @ {off})")
            req.buf.release()
    finally:
        if fd is not None:
            os.close(fd)
        if path is not None:
            os.unlink(path)


class _NullEngineCls:
    """Stand-in engine for probe requests: no counters, no callbacks."""

    @staticmethod
    def _on_complete(req) -> None:
        pass


_NullEngine = _NullEngineCls()


def available_backends() -> List[str]:
    """Names of backends that construct AND pass the self-check on this
    host (probe is cheap; used by tests and the benchmark matrix)."""
    out = []
    pool = PinnedBufferPool(max_bytes=4 << 20)
    for name in _PROBE_ORDER:
        try:
            b = _BACKENDS[name]()
            try:
                _self_check(b, pool)
                out.append(name)
            finally:
                b.close()
        except Exception:
            continue
    pool.close()
    return out


class IOEngine:
    """Facade over one probed backend: submit/reap reads, live byte
    counters, byte-budget admission, idle-transition callbacks."""

    def __init__(self, backend: Optional[str] = None, *,
                 depth: int = 64, aio_workers: int = 4,
                 max_bytes_in_flight: Optional[int] = None,
                 pool: Optional[PinnedBufferPool] = None,
                 pool_bytes: int = 64 << 20):
        forced = backend or os.environ.get(ENV_ENGINE) or None
        self.pool = pool or PinnedBufferPool(max_bytes=pool_bytes)
        self._owns_pool = pool is None
        self._cond = threading.Condition()
        self._in_flight = 0
        self._bytes_in_flight = 0
        self.max_bytes_in_flight = max_bytes_in_flight
        # edge-disk emulation: when set, read reaps are paced by a shared
        # token bucket to this many bytes/s (one simulated device, shared
        # by every in-flight read — NOT per-request).  CI hosts serve the
        # store from page cache at memory speed; the paper's subject is
        # edge flash at ~100-400 MB/s, and benchmarks that depend on disk
        # time being real (e.g. the warm-transfer race) set this knob.
        self.sim_read_bytes_per_s: Optional[float] = None
        self._sim_next_free = 0.0
        self._idle_callbacks: List[Callable[[], None]] = []
        self._closed = False
        self.stats = {"submitted": 0, "reaped": 0, "errors": 0,
                      "bytes_submitted": 0, "bytes_reaped": 0,
                      "transfer_charges": 0, "transfer_bytes": 0,
                      "budget_waits": 0, "idle_transitions": 0,
                      "probe_rejected": []}
        self.backend = self._probe(forced, depth, aio_workers)
        self.name = self.backend.name

    def _probe(self, forced: Optional[str], depth: int, aio_workers: int):
        order = (forced,) if forced else _PROBE_ORDER
        last_err: Optional[BaseException] = None
        for name in order:
            if name not in _BACKENDS:
                raise ValueError(
                    f"unknown I/O engine {name!r} "
                    f"(choices: {sorted(_BACKENDS)})")
            try:
                kw: Dict[str, Any] = {}
                if name == "uring":
                    kw["entries"] = depth
                elif name == "aio":
                    kw["workers"] = aio_workers
                b = _BACKENDS[name](**kw)
                try:
                    _self_check(b, self.pool)
                except BaseException:
                    b.close()
                    raise
                return b
            except Exception as e:
                last_err = e
                self.stats["probe_rejected"].append(f"{name}: {e}")
        raise RuntimeError(
            f"I/O engine backend {forced!r} failed its self-check: "
            f"{last_err}") from last_err

    # -- submit / reap ------------------------------------------------------
    def submit(self, fd: int, offset: int, nbytes: int, *,
               key: Optional[str] = None, injector=None) -> ReadTicket:
        """Queue one read.  Blocks while the bytes-in-flight budget is
        exhausted (an oversized single request is admitted when the
        engine is otherwise empty, so the gate can never wedge)."""
        if injector is not None:
            injector.maybe_fault("ioengine.submit", key)
        nbytes = int(nbytes)
        with self._cond:
            if self._closed:
                raise RuntimeError("IOEngine is closed")
            budget = self.max_bytes_in_flight
            if budget is not None:
                waited = False
                while (self._bytes_in_flight > 0
                       and self._bytes_in_flight + nbytes > budget):
                    waited = True
                    self._cond.wait()
                if waited:
                    self.stats["budget_waits"] += 1
            self._in_flight += 1
            self._bytes_in_flight += nbytes
            self.stats["submitted"] += 1
            self.stats["bytes_submitted"] += nbytes
            ready_at = 0.0
            if self.sim_read_bytes_per_s:
                start = max(time.monotonic(), self._sim_next_free)
                self._sim_next_free = (
                    start + nbytes / self.sim_read_bytes_per_s)
                ready_at = self._sim_next_free
        buf = self.pool.acquire(nbytes)
        req = _Request(self, fd, offset, nbytes, buf, key)
        req.ready_at = ready_at
        try:
            self.backend.submit(req)
        except BaseException as e:
            buf.release()
            self._on_complete(req)
            if isinstance(e, OSError):
                raise classify(e) from e
            raise
        return ReadTicket(req, injector=injector)

    def charge(self, nbytes: int, *, key: Optional[str] = None,
               injector=None) -> TransferCharge:
        """Admit ``nbytes`` of peer-transfer payload.

        Blocks under the same bytes-in-flight budget as :meth:`submit`
        (with the same oversized-alone escape so the gate can never
        wedge) and hands back a pool slab for the receive path to fill.
        Counted under ``transfer_charges``/``transfer_bytes`` — NOT
        ``bytes_submitted`` — so disk reads and peer transfers stay
        separately observable (the warm-transfer CI gate depends on
        this)."""
        if injector is not None:
            injector.maybe_fault("ioengine.charge", key)
        nbytes = int(nbytes)
        with self._cond:
            if self._closed:
                raise RuntimeError("IOEngine is closed")
            budget = self.max_bytes_in_flight
            if budget is not None:
                waited = False
                while (self._bytes_in_flight > 0
                       and self._bytes_in_flight + nbytes > budget):
                    waited = True
                    self._cond.wait()
                if waited:
                    self.stats["budget_waits"] += 1
            self._in_flight += 1
            self._bytes_in_flight += nbytes
            self.stats["transfer_charges"] += 1
            self.stats["transfer_bytes"] += nbytes
        buf = self.pool.acquire(nbytes)
        return TransferCharge(self, buf, nbytes, key)

    def _on_transfer_done(self, charge: TransferCharge) -> None:
        with self._cond:
            self._in_flight -= 1
            self._bytes_in_flight -= charge.nbytes
            idle = self._in_flight == 0
            if idle:
                self.stats["idle_transitions"] += 1
            callbacks = list(self._idle_callbacks) if idle else []
            self._cond.notify_all()
        for cb in callbacks:
            try:
                cb()
            except Exception:
                pass  # idle ticks are advisory; never poison the receiver

    def _on_complete(self, req: _Request) -> None:
        with self._cond:
            self._in_flight -= 1
            self._bytes_in_flight -= req.nbytes
            self.stats["reaped"] += 1
            self.stats["bytes_reaped"] += req.nbytes
            if req.error is not None:
                self.stats["errors"] += 1
            idle = self._in_flight == 0
            if idle:
                self.stats["idle_transitions"] += 1
            callbacks = list(self._idle_callbacks) if idle else []
            self._cond.notify_all()
        for cb in callbacks:
            try:
                cb()
            except Exception:
                pass  # idle ticks are advisory; never poison the reaper

    # -- admission plumbing -------------------------------------------------
    def bytes_in_flight(self) -> int:
        with self._cond:
            return self._bytes_in_flight

    def reads_in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    def set_max_bytes_in_flight(self, budget: Optional[int]) -> None:
        with self._cond:
            self.max_bytes_in_flight = budget
            self._cond.notify_all()

    def set_sim_read_bandwidth(self, bytes_per_s: Optional[float]) -> None:
        """Enable (or disable, with None/0) the edge-disk read-bandwidth
        emulation; see the ``sim_read_bytes_per_s`` note in ``__init__``."""
        with self._cond:
            self.sim_read_bytes_per_s = (
                float(bytes_per_s) if bytes_per_s else None)
            self._sim_next_free = 0.0

    def add_idle_callback(self, fn: Callable[[], None]) -> None:
        with self._cond:
            self._idle_callbacks.append(fn)

    def remove_idle_callback(self, fn: Callable[[], None]) -> None:
        with self._cond:
            try:
                self._idle_callbacks.remove(fn)
            except ValueError:
                pass

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            snap = dict(self.stats)
            snap["probe_rejected"] = list(self.stats["probe_rejected"])
            snap["backend"] = getattr(self, "name", None)
            snap["in_flight"] = self._in_flight
            snap["bytes_in_flight"] = self._bytes_in_flight
            snap["max_bytes_in_flight"] = self.max_bytes_in_flight
            snap["sim_read_bytes_per_s"] = self.sim_read_bytes_per_s
        snap["pool"] = dict(self.pool.stats)
        return snap

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until nothing is in flight (tests / shutdown barrier)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._in_flight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
        self.backend.close()
        if self._owns_pool:
            self.pool.close()


# ---------------------------------------------------------------------------
# stage engine (host | dma)
# ---------------------------------------------------------------------------

class _CudaPinnedSlabs:
    """Size-class pool of CUDA page-locked host slabs (``pin_memory=True``).

    ``mlock`` keeps pages resident but does not register them with the
    CUDA driver, so a copy from an mlocked numpy buffer is a synchronous
    pageable copy. These slabs are registered, so ``.to(device,
    non_blocking=True)`` from them is a true async DMA. A slab is only
    handed back after the copy that reads it has completed (the caller
    synchronizes on the copy's event first)."""

    def __init__(self, max_bytes: int = 32 << 20):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._free: Dict[int, list] = {}
        self._retained = 0
        self.stats = {"acquires": 0, "reuses": 0, "allocs": 0,
                      "overflow_allocs": 0}

    def acquire(self, nbytes: int):
        import torch

        cls = PinnedBufferPool._size_class(max(1, int(nbytes)))
        with self._lock:
            self.stats["acquires"] += 1
            free = self._free.get(cls)
            if free:
                self.stats["reuses"] += 1
                return cls, free.pop(), True
            pooled = self._retained + cls <= self.max_bytes
            if pooled:
                self._retained += cls
                self.stats["allocs"] += 1
            else:
                self.stats["overflow_allocs"] += 1
        return cls, torch.empty(cls, dtype=torch.uint8, pin_memory=True), \
            pooled

    def release(self, cls: int, slab, pooled: bool) -> None:
        if not pooled:
            return
        with self._lock:
            self._free.setdefault(cls, []).append(slab)

    def close(self) -> None:
        with self._lock:
            self._free, self._retained = {}, 0


class StageEngine:
    """Backend-pluggable ``stage`` op.

    host  inline ``stage_weights`` — the reference path, and the only one
          for CPU tensors, where ``torch.from_numpy`` aliases host memory
          (a pinned bounce buffer would be recycled under a live alias).
    dma   dedicated DMA-queue thread: each weight is copied into a CUDA
          page-locked bounce slab, then ``.to(device, non_blocking=True)``
          on the dedicated copy stream, then an event; the slab goes back
          to the pool only after that event completes. Serialized, so
          staging transfers never contend with each other. Auto-selected
          when torch sees a CUDA device; ``REPRO_STAGE_ENGINE`` overrides.
          A stage to a CPU device always takes the host path.
    """

    def __init__(self, backend: Optional[str] = None,
                 pool: Optional[_CudaPinnedSlabs] = None):
        forced = backend or os.environ.get(ENV_STAGE) or None
        if forced is None:
            forced = "dma" if self._accelerator_present() else "host"
        if forced not in ("host", "dma"):
            raise ValueError(f"unknown stage engine {forced!r} "
                             f"(choices: ['dma', 'host'])")
        self.name = forced
        self.pool = pool or _CudaPinnedSlabs(max_bytes=32 << 20)
        self.stats = {"staged": 0, "bytes_staged": 0, "dma_queue_peak": 0}
        self._q: Optional["queue.Queue"] = None
        self._thread: Optional[threading.Thread] = None
        if self.name == "dma":
            self._q = queue.Queue()
            self._thread = threading.Thread(
                target=self._dma_loop, name="repro-stage-dma", daemon=True)
            self._thread.start()

    @staticmethod
    def _accelerator_present() -> bool:
        try:
            import torch
            return torch.cuda.is_available()
        except Exception:
            return False

    # -- host path ----------------------------------------------------------
    def _stage_host(self, w: Dict[str, Any], device) -> Dict[str, Any]:
        from repro_torch.core.staging import stage_weights
        return stage_weights(w, device)

    # -- dma path -----------------------------------------------------------
    def _dma_loop(self) -> None:
        import torch

        from repro_torch import bf16
        from repro_torch.core.staging import StagedWeights, copy_stream
        while True:
            item = self._q.get()
            if item is None:
                return
            w, device, out, done = item
            leases = []
            try:
                stream = copy_stream(device)
                staged = StagedWeights()
                with torch.cuda.stream(stream):
                    for k, v in w.items():
                        arr = np.asarray(v)
                        cls, slab, pooled = self.pool.acquire(arr.nbytes)
                        leases.append((cls, slab, pooled))
                        host = slab.numpy()[:arr.nbytes].view(arr.dtype) \
                            .reshape(arr.shape)
                        np.copyto(host, arr)   # page-in + copy, one pass
                        staged[k] = bf16.to_tensor(host).to(
                            device, non_blocking=True)
                    staged.event = torch.cuda.Event()
                    staged.event.record(stream)
                # the bounce slabs recycle only once the DMA reading them
                # has completed
                staged.event.synchronize()
                out["staged"] = staged
            except BaseException as e:
                out["error"] = e
            finally:
                for lease in leases:
                    self.pool.release(*lease)
                done.set()

    def stage(self, w: Dict[str, Any], device) -> Dict[str, Any]:
        from repro_torch.device import as_device

        if not w:
            return {}
        device = as_device(device)
        if self.name == "host" or self._q is None or device.type != "cuda":
            staged = self._stage_host(w, device)
        else:
            out: Dict[str, Any] = {}
            done = threading.Event()
            self._q.put((w, device, out, done))
            self.stats["dma_queue_peak"] = max(
                self.stats["dma_queue_peak"], self._q.qsize())
            done.wait()
            if "error" in out:
                err = out["error"]
                if isinstance(err, BaseException):
                    raise StageFault(f"dma stage failed: {err}") from err
            staged = out["staged"]
        self.stats["staged"] += 1
        self.stats["bytes_staged"] += sum(
            int(getattr(v, "nbytes", 0)) for v in w.values())
        return staged

    def close(self) -> None:
        if self._q is not None and self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None
        self.pool.close()


# ---------------------------------------------------------------------------
# process-wide singleton (mirrors executor.pool.get_core_pool)
# ---------------------------------------------------------------------------

_engine_lock = threading.Lock()
_engine: Optional[IOEngine] = None


def get_io_engine(**kw) -> IOEngine:
    """Process-wide engine: one ring / worker set serves every model, so
    the byte counters admission control reads are global truth."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = IOEngine(**kw)
        return _engine


def current_io_engine() -> Optional[IOEngine]:
    """The process-wide engine if one was made, without making one."""
    with _engine_lock:
        return _engine


def reset_io_engine() -> None:
    global _engine
    with _engine_lock:
        eng, _engine = _engine, None
    if eng is not None:
        eng.close()


_stage_engine: Optional[StageEngine] = None


def get_stage_engine(**kw) -> StageEngine:
    global _stage_engine
    with _engine_lock:
        if _stage_engine is None:
            _stage_engine = StageEngine(**kw)
        return _stage_engine


def reset_stage_engine() -> None:
    global _stage_engine
    with _engine_lock:
        eng, _stage_engine = _stage_engine, None
    if eng is not None:
        eng.close()
