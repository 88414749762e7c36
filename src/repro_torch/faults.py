"""Typed failure domain for the cold path.

Everything that can go wrong between "bytes on flash" and "activations on the
big core" is classified here into exactly two retry semantics:

  * ``TransientFault`` — worth retrying (bounded, with backoff).  I/O hiccups,
    a stage that lost a race with memory pressure, an overdue task rescued by
    the pool watchdog.
  * ``PermanentFault`` — retrying cannot help.  Checksum mismatches, kernels
    that fault deterministically, workers that never came back.

The module is deliberately stdlib-only: ``checkpoint/`` and ``executor/`` both
import it, so it must sit below every other ``repro`` package.

Also here, because every fault consumer needs them:

  * ``RetryPolicy``     — bounded attempts + exponential backoff schedule.
  * ``FaultInjector``   — deterministic, seedable chaos: the decision to fault
                          is a pure function of (seed, site, key, attempt), so
                          a chaos run is reproducible regardless of thread
                          interleaving.
  * ``CircuitBreaker``  — per-(kernel, shape-class) trip wire persisted next
                          to the store, used to demote faulting kernels.
  * ``RepairLog``       — append-only journal of degradation events (cache
                          recomputes, kernel demotions, model quarantines).

See docs/robustness.md for the full taxonomy table and ladder semantics.
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

class Fault(Exception):
    """Base of the typed taxonomy. Carries structured context for reports."""

    retryable = False

    def __init__(self, msg: str = "", *, layer: Optional[str] = None,
                 kernel: Optional[str] = None, site: Optional[str] = None,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.layer = layer
        self.kernel = kernel
        self.site = site
        self.retry_after = retry_after

    def describe(self) -> dict:
        d = {"type": type(self).__name__, "retryable": self.retryable,
             "msg": str(self)}
        for k in ("layer", "kernel", "site", "retry_after"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


class TransientFault(Fault):
    """Retry may succeed (bounded by a RetryPolicy)."""
    retryable = True


class PermanentFault(Fault):
    """Retry cannot help; escalate (fail the job / quarantine / re-decide)."""
    retryable = False


# -- transients --------------------------------------------------------------

class ReadFault(TransientFault):
    """A store read (raw or cached) failed in a retryable way."""


class TransformFault(TransientFault):
    """A weight transform task failed in a retryable way."""


class StageFault(TransientFault):
    """Staging (device_put) failed in a retryable way."""


class ExecuteFault(TransientFault):
    """A kernel execution hiccuped in a way worth one more try."""


class DeadlineExceeded(TransientFault):
    """A task overran its deadline; the watchdog expired it."""


class JobTimeout(TransientFault, TimeoutError):
    """Job.wait()/JobHandle.result() ran out of time. Still a TimeoutError so
    pre-taxonomy callers that catch TimeoutError keep working."""


class ModelQuarantined(TransientFault):
    """The server refused a cold start because the model is in backoff after
    repeated load failures. ``retry_after`` says when to try again."""


class FetchFault(TransientFault):
    """A peer warm-state fetch failed (refused, disconnected, or a chunk
    failed its CRC). Transient by design: the local read→transform chain is
    always racing the fetch, so the caller falls back to disk rather than
    retrying the wire."""


# -- permanents --------------------------------------------------------------

class IntegrityFault(PermanentFault):
    """Stored bytes failed a checksum; the data itself is wrong."""


class KernelFault(PermanentFault):
    """A kernel faults deterministically for a shape class on this host."""


class PlanFault(PermanentFault):
    """A persisted plan is missing/corrupt/inconsistent with the model."""


class WorkerLost(PermanentFault):
    """A worker never came back — a pool thread that leaked at shutdown, or
    a front-door worker *process* that died / stopped heartbeating.

    Permanent **within** the failure domain that raised it: the thread or
    process is gone and retrying there cannot help. One tier up it becomes
    recoverable — the ``FrontDoor`` supervisor catches ``WorkerLost`` for a
    crashed worker and *fails the in-flight request over* to a sibling
    (cold starts are idempotent by construction, so the replay is safe),
    only surfacing it to the client when no sibling can serve."""


#: OS errors that plausibly heal on retry. Everything else (ENOENT, EACCES,
#: ENOSPC, ...) is a real condition retrying will not fix.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.ETIMEDOUT,
    getattr(errno, "EREMOTEIO", errno.EIO),
})


def classify(exc: BaseException, *, site: Optional[str] = None,
             layer: Optional[str] = None) -> BaseException:
    """Map an arbitrary exception onto the taxonomy.

    Typed faults pass through unchanged. A transient-errno OSError becomes a
    ReadFault chained to the original. Anything else is returned as-is —
    unknown errors are NOT retried (a programming error should surface, not
    loop).
    """
    if isinstance(exc, Fault):
        return exc
    if isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS:
        f = ReadFault(f"transient I/O error ({exc})", site=site, layer=layer)
        f.__cause__ = exc
        return f
    return exc


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, TransientFault)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff. ``max_attempts`` counts the
    first try: 3 means one try plus up to two retries."""

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return self.backoff_s * (self.backoff_mult ** max(attempt - 1, 0))


DEFAULT_RETRY = RetryPolicy()


# ---------------------------------------------------------------------------
# supervision policies (the front-door tier)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeartbeatPolicy:
    """Liveness contract between a supervisor and a worker process: the
    worker beats every ``interval_s``; ``miss_threshold`` consecutive missed
    beats (no message of any kind) declare it lost."""

    interval_s: float = 0.2
    miss_threshold: int = 5

    @property
    def timeout_s(self) -> float:
        return self.interval_s * self.miss_threshold


@dataclass(frozen=True)
class RestartPolicy:
    """Supervisor restart schedule: exponential backoff between restarts of
    a crashing worker, capped at ``max_s``. ``max_restarts=None`` restarts
    forever (a serving tier should keep trying); a bound turns a flapping
    worker into a permanently-removed one."""

    base_s: float = 0.05
    mult: float = 2.0
    max_s: float = 5.0
    max_restarts: Optional[int] = None

    def delay(self, restarts: int) -> float:
        """Backoff before restart number ``restarts`` (1-based)."""
        return min(self.max_s, self.base_s * (self.mult ** max(restarts - 1, 0)))


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

#: default fault class raised per injection site
SITE_FAULTS = {
    "store.read_raw": ReadFault,
    "store.read_cached": ReadFault,
    "ioengine.submit": ReadFault,
    "ioengine.reap": ReadFault,
    "ioengine.charge": FetchFault,
    "task.read": ReadFault,
    "task.transform": TransformFault,
    "task.stage": StageFault,
    "task.execute": ExecuteFault,
    "task.fetch_remote": FetchFault,
    "warmstate.fetch": FetchFault,
    "warmstate.chunk": FetchFault,
    "kernel.execute": KernelFault,
}


class FaultInjector:
    """Deterministic, seedable chaos.

    Hook points (``maybe_fault(site, key)``) live in store reads, pool task
    execution, and kernel dispatch. Whether call *n* at a given (site, key)
    faults is a pure function of (seed, site, key, n): a SHA-1 of that tuple
    mapped to [0, 1) and compared against the site's rate. Per-(site, key)
    call counters are kept under a lock, so the decision sequence is identical
    however worker threads interleave — the property the chaos gate's
    bit-identical assertion rests on.

    ``max_faults_per_key`` caps injected faults per (site, key) so a retry
    policy with ``max_attempts > max_faults_per_key`` is guaranteed to clear
    every injected fault eventually (no p^max_attempts run-failure tail).
    ``keys`` optionally restricts a site to an explicit key set (used to
    target one layer in the degradation gates).
    """

    def __init__(self, seed: int = 0, *,
                 rates: Optional[Dict[str, float]] = None,
                 max_faults_per_key: Optional[int] = 2,
                 keys: Optional[Dict[str, Set[str]]] = None):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.max_faults_per_key = max_faults_per_key
        self.keys = {k: set(v) for k, v in (keys or {}).items()}
        self._lock = threading.Lock()
        self._calls: Dict[tuple, int] = {}
        self._faulted: Dict[tuple, int] = {}
        self.injected: List[dict] = []

    def _decide(self, site: str, key: str, n: int, p: float) -> bool:
        h = hashlib.sha1(f"{self.seed}|{site}|{key}|{n}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / float(1 << 64)
        return frac < p

    def maybe_fault(self, site: str, key: str) -> None:
        """Raise the site's fault type if this (site, key, call#) is chosen."""
        p = self.rates.get(site, 0.0)
        if p <= 0.0:
            return
        allowed = self.keys.get(site)
        if allowed is not None and key not in allowed:
            return
        with self._lock:
            sk = (site, key)
            n = self._calls.get(sk, 0)
            self._calls[sk] = n + 1
            nf = self._faulted.get(sk, 0)
            if (self.max_faults_per_key is not None
                    and nf >= self.max_faults_per_key):
                return
            if not self._decide(site, key, n, p):
                return
            self._faulted[sk] = nf + 1
            self.injected.append({"site": site, "key": key, "call": n})
        cls = SITE_FAULTS.get(site, TransientFault)
        raise cls(f"injected fault at {site} ({key}, call {n})",
                  site=site, layer=key)

    @property
    def n_injected(self) -> int:
        with self._lock:
            return len(self.injected)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Per-key (``"<kernel>:<shape-class>"``) trip wire, persisted to JSON so
    a kernel that faults on this host stays demoted across processes until an
    explicit re-decide resets it."""

    def __init__(self, path: Optional[Path] = None, *, threshold: int = 1):
        self.path = Path(path) if path is not None else None
        self.threshold = max(int(threshold), 1)
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            try:
                raw = json.loads(self.path.read_text())
                if isinstance(raw, dict):
                    self._state = {str(k): dict(v) for k, v in raw.items()
                                   if isinstance(v, dict)}
            except (OSError, ValueError):
                self._state = {}  # corrupt breaker file = no open breakers

    @staticmethod
    def key(kernel: str, shape_class: str) -> str:
        return f"{kernel}:{shape_class}"

    def allow(self, key: str) -> bool:
        with self._lock:
            st = self._state.get(key)
            return not (st and st.get("open"))

    def record_failure(self, key: str, reason: str = "") -> bool:
        """Record one failure; returns True when this call opened the breaker."""
        with self._lock:
            st = self._state.setdefault(key, {"failures": 0, "open": False})
            st["failures"] += 1
            st["reason"] = reason[:200]
            opened = (not st["open"]) and st["failures"] >= self.threshold
            if opened:
                st["open"] = True
        if opened:
            self.save()
        return opened

    def record_success(self, key: str) -> None:
        with self._lock:
            self._state.pop(key, None)

    def reset(self) -> None:
        with self._lock:
            self._state.clear()
        self.save()

    def open_keys(self) -> List[str]:
        with self._lock:
            return sorted(k for k, v in self._state.items() if v.get("open"))

    def save(self) -> None:
        if self.path is None:
            return
        with self._lock:
            blob = json.dumps(self._state, indent=0, sort_keys=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(blob)
        os.replace(tmp, self.path)


# ---------------------------------------------------------------------------
# repair log
# ---------------------------------------------------------------------------

class RepairLog:
    """Thread-safe record of degradation/repair events; optionally journaled
    to a ``repairs.jsonl`` next to the store so operators (and tools/scrub.py)
    can see what the ladder did.

    The on-disk journal is size-capped: once it grows past ``max_bytes`` it
    rotates to ``repairs.jsonl.1`` (shifting older generations up to
    ``retention``, the oldest dropped) so a long-running server's advisory
    log can never leak disk. The in-memory event list is capped alongside it
    (``max_events``, oldest evicted) for the same reason."""

    def __init__(self, path: Optional[Path] = None, *,
                 max_bytes: int = 4 * 1024 * 1024, retention: int = 3,
                 max_events: int = 10_000):
        self.path = Path(path) if path is not None else None
        self.max_bytes = int(max_bytes)
        self.retention = max(int(retention), 1)
        self.max_events = max(int(max_events), 1)
        self._lock = threading.Lock()
        self.events: List[dict] = []
        self.rotations = 0

    def _rotate_locked(self) -> None:
        """Shift repairs.jsonl -> .1 -> .2 ... dropping past ``retention``."""
        try:
            for i in range(self.retention - 1, 0, -1):
                src = self.path.with_name(self.path.name + f".{i}")
                if src.exists():
                    os.replace(src, self.path.with_name(
                        self.path.name + f".{i + 1}"))
            stale = self.path.with_name(
                self.path.name + f".{self.retention + 1}")
            if stale.exists():
                stale.unlink()
            os.replace(self.path, self.path.with_name(self.path.name + ".1"))
            self.rotations += 1
        except OSError:
            pass  # advisory; a failed rotation must never fail a request

    def record(self, kind: str, **ctx) -> dict:
        ev = {"kind": kind, "ts": time.time()}
        ev.update({k: v for k, v in ctx.items() if v is not None})
        with self._lock:
            self.events.append(ev)
            if len(self.events) > self.max_events:
                del self.events[:len(self.events) - self.max_events]
            if self.path is not None:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps(ev, default=str) + "\n")
                        size = f.tell()
                    if size > self.max_bytes:
                        self._rotate_locked()
                except OSError:
                    pass  # the log is advisory; never fail a request over it
        return ev

    def of_kind(self, kind: str) -> List[dict]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for e in self.events:
                out[e["kind"]] = out.get(e["kind"], 0) + 1
            return out
