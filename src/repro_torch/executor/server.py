"""ColdServer — multi-model cold serving on one persistent core pool.

The server owns N ``ColdEngine``s (one per model, each with its own store
under the server root) and shares across all of them:

  * the process-wide ``CorePool`` — one set of big/little workers serves
    every model's prep chains and exec chains, with per-job accounting;
  * one user-level ``ProfileDB`` — a second model whose layers fall into
    already-measured shape classes performs zero profile calls;
  * an **admission controller**: §3.2 measures I/O interference between
    co-running preparation ops *per host*, so the number of cold starts
    simultaneously in their prep phase is capped (``max_concurrent_preps``);
    further cold starts queue at admission and enter as slots free
    (released the moment a job's last read/transform/stage finishes —
    its exec tail does not hold the slot);
  * an **LRU residency budget**: finished cold starts leave their staged
    weights device-resident for warm reuse; when the total exceeds
    ``memory_budget_bytes`` the least-recently-used model's weights are
    evicted (its next request is simply cold again);
  * the process-wide **async I/O engine** (``repro_torch.ioengine``): every
    engine's prep reads flow through one submit/reap queue, so the server
    can cap *bytes in flight* across all co-admitted cold starts
    (``max_read_bytes_in_flight``) — the byte-granular complement to the
    job-granular prep-slot semaphore — and use the engine's idle signal
    (no reads in flight) to run bounded incremental store compaction
    exactly when the disk has nothing better to do.

This is the port of ``repro/executor/server.py`` on the H100. Every
engine it adds takes the server's ``device`` (default ``"cuda"``, which
raises without a card). Warm runs execute the staged tensors on the
engine's stream and synchronize it, where the reference calls
``jax.block_until_ready``. Peer warm-state transfers
(``executor/warmstate.py``) read the resident staged tensors: the
``WarmStateServer`` copies each to pinned host memory before its
CRC-32C, and the fetching side stages what lands through the same stage
path as a local read.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.engine import ColdEngine, LayerDef
from repro_torch.core.pipeline import PipelineJob, RunResult
from repro_torch.core.profiler import ProfileDB
from repro_torch.core.scheduler import transfer_estimate
from repro_torch.core.staging import consume
from repro_torch.device import on_stream, resolve_device, sync, to_device
from repro_torch.executor.pool import CorePool, get_core_pool
from repro_torch.executor.warmstate import PACKED_LAYER, PeerFetcher
from repro_torch.faults import DeadlineExceeded, ModelQuarantined


def _weights_nbytes(weights: Optional[Dict[str, Any]]) -> int:
    total = 0
    for w in (weights or {}).values():
        for v in w.values():
            total += int(getattr(v, "nbytes", 0))
    return total


class MemoryBudget:
    """One accounted device-memory pool shared by every consumer.

    The ColdServer's staged-weight LRU and the LLM ``BatchedServer``'s
    KV-cache allocator both draw from this single pool: each ``reserve``
    is tagged, and when a reservation would overflow ``total_bytes`` the
    registered evictors (the ColdServer's LRU) free least-recently-used
    staged weights first.  ``reserve`` never refuses — a KV allocation is
    a correctness requirement — it evicts what it can and returns whether
    the pool is still within budget, so callers (and the warm-state
    transfer server's memory-pressure refusal) can see the overcommit.
    ``total_bytes=None`` disables the cap but keeps the accounting."""

    def __init__(self, total_bytes: Optional[int] = None):
        self.total = (None if total_bytes is None else int(total_bytes))
        self._lock = threading.Lock()
        self._used: Dict[str, int] = {}
        self._evictors: List[Callable[[int], int]] = []

    def add_evictor(self, cb: Callable[[int], int]) -> None:
        """``cb(need_bytes) -> freed_bytes``; must not call ``reserve``."""
        self._evictors.append(cb)

    def used(self) -> int:
        with self._lock:
            return sum(self._used.values())

    def used_by(self, tag: str) -> int:
        with self._lock:
            return int(self._used.get(tag, 0))

    def over_budget(self) -> bool:
        return self.total is not None and self.used() > self.total

    def charge(self, tag: str, nbytes: int) -> None:
        """Unconditional accounting (no eviction)."""
        with self._lock:
            self._used[tag] = self._used.get(tag, 0) + int(nbytes)

    def release(self, tag: str, nbytes: Optional[int] = None) -> None:
        with self._lock:
            if nbytes is None:
                self._used.pop(tag, None)
            else:
                left = self._used.get(tag, 0) - int(nbytes)
                if left > 0:
                    self._used[tag] = left
                else:
                    self._used.pop(tag, None)

    def reserve(self, tag: str, nbytes: int) -> bool:
        """Charge ``nbytes`` to ``tag``, evicting LRU state to make room.
        True = within budget afterwards; False = overcommitted (charged
        anyway — the evictors could not free enough)."""
        nbytes = int(nbytes)
        if self.total is None:
            self.charge(tag, nbytes)
            return True
        while True:
            with self._lock:
                if sum(self._used.values()) + nbytes <= self.total:
                    self._used[tag] = self._used.get(tag, 0) + nbytes
                    return True
                need = sum(self._used.values()) + nbytes - self.total
            freed = 0
            for ev in self._evictors:
                try:
                    freed += ev(need - freed)
                except Exception:
                    continue
                if freed >= need:
                    break
            if freed <= 0:
                self.charge(tag, nbytes)
                return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"total": self.total,
                    "used": sum(self._used.values()),
                    "by_tag": dict(self._used)}


class ColdStart:
    """Handle for one admitted cold-start request."""

    def __init__(self, server: "ColdServer", model: str, job: PipelineJob):
        self.server = server
        self.model = model
        self.job = job

    @property
    def traces(self):
        return self.job.traces

    def done(self) -> bool:
        return self.job.done()

    def result(self, timeout: Optional[float] = None) -> RunResult:
        try:
            res = self.job.result(timeout)
        except TimeoutError:
            raise  # caller-side wait timeout (JobTimeout), not a model
            #        failure — the admission slot releases when the job's
            #        prep phase ends on its own
        except DeadlineExceeded:
            raise  # deadline pressure (watchdog expiry), not model
            #        sickness: quarantining here would punish a healthy
            #        model for an over-tight budget
        except Exception as e:
            self.server._record_model_failure(self.model, e)
            raise
        self.server._register_resident(self.model, res)
        self.server._clear_model_failure(self.model)
        return res


class ColdServer:
    def __init__(
        self,
        root,
        *,
        pool: Optional[CorePool] = None,
        n_little: int = 3,
        n_big: int = 2,
        max_concurrent_preps: int = 2,
        memory_budget_bytes: Optional[int] = None,
        share_profile_db: bool = True,
        quarantine_base_s: float = 0.5,
        quarantine_max_s: float = 30.0,
        io_engine: Any = "auto",
        max_read_bytes_in_flight: Optional[int] = None,
        idle_compaction: bool = True,
        idle_compaction_min_interval_s: float = 0.25,
        budget: Optional[MemoryBudget] = None,
        device: Any = "cuda",
    ):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.pool = pool or get_core_pool(n_little=n_little, n_big=n_big)
        self.n_little = n_little
        self.max_concurrent_preps = max_concurrent_preps
        # one accounted device-memory pool: staged-weight residency (this
        # server's LRU), packed decode params, and — when the same budget
        # is handed to a BatchedServer — KV-cache growth all draw from it
        self.budget = budget if budget is not None \
            else MemoryBudget(memory_budget_bytes)
        self.budget.add_evictor(self._evict_for_budget)
        # one user-level profile DB shared by every managed engine: sibling
        # models with equivalent shape classes skip profiling entirely
        # (NOTE: ``memory_budget_bytes`` is a live property over
        # ``budget.total`` — assigning it retunes the shared pool)
        self.profile_db: Optional[ProfileDB] = (
            ProfileDB(self.root / "profile_db.json") if share_profile_db
            else None)
        self.engines: Dict[str, ColdEngine] = {}
        self._admission = threading.Semaphore(max_concurrent_preps)
        self._lock = threading.Lock()
        self._resident: "OrderedDict[str, int]" = OrderedDict()  # name->bytes
        self._resident_weights: Dict[str, Dict[str, Any]] = {}
        # per-model quarantine after failed cold starts: exponential backoff
        # keeps a sick model from burning admission slots on doomed retries
        self.quarantine_base_s = quarantine_base_s
        self.quarantine_max_s = quarantine_max_s
        self._model_quarantine: Dict[str, Dict[str, float]] = {}
        self.stats = {"admitted": 0, "evictions": 0, "active_preps": 0,
                      "max_active_preps": 0, "cold_starts": 0,
                      "load_failures": 0, "quarantined": 0,
                      "idle_compactions": 0, "idle_compaction_bytes": 0,
                      "idle_reprofiles": 0, "warm_runs": 0,
                      "warm_batches": 0, "peer_races": 0,
                      "peer_races_declined": 0, "peer_layers_fetched": 0,
                      "peer_bytes_fetched": 0, "peer_crc_failures": 0,
                      "peer_refusals": 0, "transfers_served": 0,
                      "transfer_refusals": 0}
        # packed decode params (LLM bridge) by model — servable over the
        # warm-state channel under the reserved ``__packed__`` pseudo-layer
        self._packed_state: Dict[str, Dict[str, Any]] = {}
        # peer link bandwidth EWMA, seeded by the first measured transfer;
        # feeds the same transfer_estimate the front door routes with
        self._link_bw: Optional[float] = None
        # test/operator lever: refuse every warm-state transfer request
        self.refuse_transfers = False
        # graceful drain (front-door worker handoff): _draining refuses new
        # admissions; _outstanding counts in-flight cold starts end-to-end
        # (admission -> job done), so drain() can wait the tail out
        self._draining = False
        self._outstanding = 0
        self._drain_cv = threading.Condition(self._lock)
        self._served: Dict[str, int] = {}   # model -> completed requests
        # shared async I/O engine: byte-budget admission + idle compaction.
        # "auto" binds the process-wide engine; False/None runs without one
        # (engines fall back to their own resolution / the sync path).
        if io_engine == "auto":
            from repro_torch.ioengine import get_io_engine

            self.io_engine = get_io_engine()
        else:
            self.io_engine = io_engine or None
        if self.io_engine is not None and max_read_bytes_in_flight is not None:
            self.io_engine.set_max_bytes_in_flight(max_read_bytes_in_flight)
        # idle-tick incremental compaction: when the engine's read queue
        # drains, give ONE store (round-robin) one bounded background
        # maintain() pass — dead super-bundle extents get reclaimed in the
        # gaps between cold starts instead of stalling a decide()
        self._idle_min_interval = float(idle_compaction_min_interval_s)
        self._idle_last = 0.0
        self._idle_rr = 0
        self._idle_busy = False
        self._idle_compaction = bool(idle_compaction)
        if self.io_engine is not None and idle_compaction:
            self.io_engine.add_idle_callback(self._on_io_idle)

    # -- model management ---------------------------------------------------
    def add_model(self, name: str, layers: List[LayerDef],
                  **engine_kw) -> ColdEngine:
        if name in self.engines:
            raise ValueError(f"model {name!r} already added")
        engine_kw.setdefault("pool", self.pool)
        if self.profile_db is not None:
            engine_kw.setdefault("profile_db", self.profile_db)
        if self.io_engine is not None:
            engine_kw.setdefault("io_engine", self.io_engine)
        engine_kw.setdefault("device", self.device)
        eng = ColdEngine(layers, self.root / name, **engine_kw)
        self.engines[name] = eng
        return eng

    def decide(self, name: str, x_example, **kw) -> Dict[str, Any]:
        kw.setdefault("n_little", self.n_little)
        return self.engines[name].decide(x_example, **kw)

    # -- serving ------------------------------------------------------------
    def cold_start(self, name: str, x, *, n_little: Optional[int] = None,
                   graph_hook=None, deadline_s: Optional[float] = None,
                   peers: Optional[Sequence[Dict[str, Any]]] = None,
                   ) -> ColdStart:
        """Admit one cold-start request (blocks while ``max_concurrent_preps``
        jobs are in their prep phase) and submit its task graph.

        ``deadline_s`` is the request's remaining end-to-end budget — it
        becomes the job's watchdog deadline (typed ``DeadlineExceeded``
        once blown), and a budget already too small to cover the queue is
        shed HERE, before the admission semaphore is touched.

        ``peers`` lists sibling workers holding this model resident
        (``{"host", "port", "resident_bytes", "link_bytes_per_s"?}``).
        When the best peer's ``transfer_estimate`` beats the plan's local
        cold estimate, the job is armed with a :class:`PeerFetcher` and
        every local prep chain races a ``fetch_remote`` task."""
        eng = self.engines[name]
        now = time.monotonic()
        with self._lock:
            if self._draining:
                raise RuntimeError(f"server draining: {name!r} refused")
            q = self._model_quarantine.get(name)
            if q is not None and now < q["until"]:
                self.stats["quarantined"] += 1
                retry_after = q["until"] - now
                raise ModelQuarantined(
                    f"model {name!r} quarantined after "
                    f"{int(q['fails'])} failed cold start(s); retry in "
                    f"{retry_after:.2f}s", retry_after=retry_after)
        if deadline_s is not None and deadline_s <= 0:
            raise DeadlineExceeded(
                f"request for {name!r} arrived with no budget left "
                f"({deadline_s:.3f}s) — shed before admission")
        # degradation ladder: a missing/corrupt offline decision falls back
        # to a validated plan.json reload or the default heuristic plan —
        # the request proceeds degraded instead of failing admission
        eng.ensure_plan(x, n_little=n_little or self.n_little)
        t_admit = time.monotonic()
        self._admission.acquire()
        # the admission wait itself consumed budget; what reaches the pool
        # watchdog is the REMAINING slice (shed typed if it went negative)
        if deadline_s is not None:
            deadline_s -= time.monotonic() - t_admit
            if deadline_s <= 0:
                self._admission.release()
                raise DeadlineExceeded(
                    f"request for {name!r} spent its whole budget queued "
                    f"at admission — shed before its prep started")
        with self._lock:
            self.stats["admitted"] += 1
            self.stats["cold_starts"] += 1
            self.stats["active_preps"] += 1
            self.stats["max_active_preps"] = max(
                self.stats["max_active_preps"], self.stats["active_preps"])
            self._outstanding += 1
            self._served[name] = self._served.get(name, 0) + 1
        peer_fetch = self._maybe_peer_fetch(name, peers) if peers else None
        try:
            job = eng.submit_cold(x, n_little=n_little or self.n_little,
                                  graph_hook=graph_hook,
                                  deadline_s=deadline_s,
                                  peer_fetch=peer_fetch)
        except BaseException:
            if peer_fetch is not None:
                peer_fetch.close()
            self._release_prep_slot()
            self._request_done()
            raise
        job.job.add_preps_callback(lambda _job: self._release_prep_slot())
        job.job.add_done_callback(lambda _job: self._request_done())
        if peer_fetch is not None:
            job.job.add_done_callback(
                lambda _job: self._note_fetch_stats(peer_fetch))
        return ColdStart(self, name, job)

    # -- peer warm-state transfer ---------------------------------------------
    def _maybe_peer_fetch(self, name: str,
                          peers: Sequence[Dict[str, Any]]
                          ) -> Optional[PeerFetcher]:
        """Arm the fetch race iff the best peer's transfer estimate beats
        the plan's local cold estimate — the SAME ``transfer_estimate``
        arithmetic the front door routes with, so routing and execution
        never disagree about when a transfer is worth it."""
        eng = self.engines[name]
        with self._lock:
            link_bw = self._link_bw
        best = None
        for p in peers:
            bw = float(p.get("link_bytes_per_s") or link_bw or 0.0)
            est = transfer_estimate(int(p.get("resident_bytes") or 0), bw)
            if best is None or est < best[0]:
                best = (est, p)
        if best is None:
            return None
        # local cold estimate: the plan's simulated makespan (read +
        # transform + stage + exec). 0.0 = fallback/degraded plan, cost
        # unknown — peer RAM almost always beats cold disk, so arm.
        local_est = float(eng.plan.est_makespan) if eng.plan else 0.0
        if local_est > 0.0 and best[0] >= local_est:
            with self._lock:
                self.stats["peer_races_declined"] += 1
            return None
        with self._lock:
            self.stats["peer_races"] += 1
        host, port = best[1]["host"], int(best[1]["port"])
        return PeerFetcher(name, [(host, port)], io_engine=self.io_engine,
                           injector=eng.fault_injector)

    def _note_fetch_stats(self, pf: PeerFetcher) -> None:
        """Job-done hook: fold the race's outcome into the server stats and
        the link-bandwidth EWMA the next routing decision uses."""
        s = pf.stats
        with self._lock:
            self.stats["peer_layers_fetched"] += int(s["layers_fetched"])
            self.stats["peer_bytes_fetched"] += int(s["bytes_fetched"])
            self.stats["peer_crc_failures"] += int(s["crc_failures"])
            self.stats["peer_refusals"] += int(s["refused"])
            bw = float(s.get("measured_bytes_per_s") or 0.0)
            if bw > 0.0:
                self._link_bw = (bw if self._link_bw is None
                                 else 0.7 * self._link_bw + 0.3 * bw)

    def _request_done(self):
        with self._drain_cv:
            self._outstanding -= 1
            self._drain_cv.notify_all()

    # -- graceful drain (front-door worker handoff) --------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new admissions and wait for every in-flight cold start to
        finish. True = fully drained; False = requests still running at
        ``timeout`` (the supervisor escalates to a hard stop). Idempotent;
        ``resume()`` reopens admission."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._drain_cv:
            self._draining = True
            while self._outstanding > 0:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._drain_cv.wait(left)
        return True

    def resume(self) -> None:
        with self._lock:
            self._draining = False

    def _release_prep_slot(self):
        with self._lock:
            self.stats["active_preps"] -= 1
        self._admission.release()
        # the engine's idle edge usually lands while this job's transform/
        # stage tail is still running (active_preps > 0, tick skipped) —
        # re-check when the prep phase itself ends
        if self.io_engine is not None and self._idle_compaction \
                and self.io_engine.reads_in_flight() == 0:
            self._on_io_idle()

    # -- idle-tick incremental compaction ------------------------------------
    def _on_io_idle(self):
        """Engine idle signal (reads in flight hit zero): run ONE bounded
        background ``maintain()`` pass on the next store, round-robin, that
        has reclaimable dead extents. Rate-limited so a bursty
        submit/drain/submit pattern cannot thrash compactions; skipped
        entirely while a previous idle compaction is still running or any
        cold start is mid-prep (its reads resume in a moment — the disk is
        not actually idle)."""
        now = time.monotonic()
        with self._lock:
            if (self._idle_busy or self.stats["active_preps"] > 0
                    or now - self._idle_last < self._idle_min_interval):
                return
            self._idle_busy = True
            names = list(self.engines)
            rr = self._idle_rr
        # off the engine's completion thread: a compaction must never delay
        # the reap of reads submitted right after the idle edge
        threading.Thread(target=self._idle_tick, args=(names, rr),
                         name="repro-idle-compact", daemon=True).start()

    def _idle_tick(self, names: List[str], rr: int):
        reclaimed = 0
        ticked = False
        reprofiled = 0
        try:
            for off in range(len(names)):
                name = names[(rr + off) % len(names)]
                store = self.engines[name].store
                try:
                    out = store.maintain(background=True)
                    # bounded per tick: at most one store's compaction, and
                    # we join it here so "busy" covers the whole pass
                    joined = store.maintain_wait()
                except Exception:
                    continue  # sick store: quarantine handles it elsewhere
                if out.get("compacted"):
                    reclaimed = int((joined or out).get(
                        "reclaimed_bytes", 0))
                    ticked = True
                    rr = (rr + off + 1) % len(names)
                    break
            # host-fingerprint drift: re-measure ONE stale shape class per
            # idle tick (round-robin over engines) — profiling happens in
            # the gaps between cold starts, never on the request path
            for off in range(len(names)):
                eng = self.engines[names[(rr + off) % len(names)]]
                try:
                    reprofiled = eng.reprofile_stale(max_classes=1)
                except Exception:
                    continue  # advisory refresh; the stale estimate serves
                if reprofiled:
                    break
        finally:
            with self._lock:
                self._idle_busy = False
                self._idle_last = time.monotonic()
                self._idle_rr = rr
                if ticked:
                    self.stats["idle_compactions"] += 1
                    self.stats["idle_compaction_bytes"] += reclaimed
                if reprofiled:
                    self.stats["idle_reprofiles"] += reprofiled

    # -- model quarantine ---------------------------------------------------
    def _record_model_failure(self, name: str, exc: BaseException) -> None:
        """A cold start failed past all retries: quarantine the model with
        exponential backoff so repeated doomed loads neither burn admission
        slots nor poison the LRU."""
        with self._lock:
            q = self._model_quarantine.setdefault(
                name, {"fails": 0, "until": 0.0})
            q["fails"] += 1
            backoff = min(self.quarantine_max_s,
                          self.quarantine_base_s * (2 ** (q["fails"] - 1)))
            q["until"] = time.monotonic() + backoff
            fails = int(q["fails"])
            self.stats["load_failures"] += 1
        eng = self.engines.get(name)
        if eng is not None:
            eng.repairs.record("model_quarantined", model=name, fails=fails,
                               backoff_s=backoff, reason=repr(exc))

    def _clear_model_failure(self, name: str) -> None:
        with self._lock:
            self._model_quarantine.pop(name, None)

    def health(self) -> Dict[str, Any]:
        """One machine-readable snapshot of the server's fault domain AND
        its residency — plain dict/list/scalar values only, so the snapshot
        serializes over the front-door heartbeat channel and feeds its
        cache-aware routing cost estimate (``resident`` = staged weights
        device-resident → near-free warm run; ``served`` = this worker has
        cold-started the model before → store/page cache warm)."""
        with self._lock:
            snap = {
                "stats": dict(self.stats),
                "quarantine": {n: dict(q) for n, q
                               in self._model_quarantine.items()},
                "resident": list(self._resident),
                "resident_bytes": sum(self._resident.values()),
                "resident_model_bytes": dict(self._resident),
                "models": list(self.engines),
                "served": dict(self._served),
                "outstanding": int(self._outstanding),
                "draining": bool(self._draining),
                "link_bytes_per_s": float(self._link_bw or 0.0),
            }
        snap["pool"] = dict(getattr(self.pool, "health", {}) or {})
        snap["budget"] = self.budget.snapshot()
        # bytes this worker's engines pulled off the LOCAL disk
        # (peer-transferred bytes count in stats["peer_bytes_fetched"]
        # instead, never here)
        total_read = 0
        for eng in self.engines.values():
            try:
                total_read += int(eng.store.bytes_served())
            except Exception:
                pass
        snap["local_read_bytes"] = total_read
        if self.io_engine is not None:
            snap["io_engine"] = self.io_engine.snapshot()
        return snap

    def run(self, name: str, x) -> RunResult:
        """Serve one request: resident weights (warm) if available, else a
        full admitted cold start."""
        warm = self.warm_run(name, x)
        if warm is not None:
            return warm
        return self.cold_start(name, x).result()

    def warm_run(self, name: str, x) -> Optional[RunResult]:
        """Execute against resident (post-cold) weights; None if evicted or
        never cold-started."""
        with self._lock:
            weights = self._resident_weights.get(name)
            if weights is None:
                return None
            self._resident.move_to_end(name)    # LRU touch
            self.stats["warm_runs"] += 1
            self._served[name] = self._served.get(name, 0) + 1
        eng = self.engines[name]
        rt = eng._runtime(n_little=self.n_little, work_stealing=True)
        t0 = time.perf_counter()
        stream = eng._stream
        y = to_device(x, eng.device, stream)
        with on_stream(stream):
            for lname in rt.order:
                y = rt.jitted[lname](consume(weights.get(lname, {}), stream),
                                     y)
        sync(stream)
        return RunResult(output=y, total_s=time.perf_counter() - t0,
                         weights=weights)

    # -- residency / eviction ----------------------------------------------
    def _register_resident(self, name: str, res: RunResult):
        nbytes = _weights_nbytes(res.weights)
        if not nbytes:
            return
        with self._lock:
            old = self._resident.pop(name, None)
            self._resident[name] = nbytes
            self._resident_weights[name] = res.weights
        if old:
            self.budget.release(f"staged:{name}", old)
        # reserve OUTSIDE self._lock: the budget's evictors re-enter the
        # server lock to pop LRU victims (dropping the dict refs is the
        # eviction; the caching allocator takes the memory back)
        self.budget.reserve(f"staged:{name}", nbytes)

    def _evict_for_budget(self, need: int) -> int:
        """MemoryBudget evictor: free least-recently-used staged weights
        (always keeping the newest model) until ``need`` bytes are freed
        or nothing evictable remains. Returns bytes freed."""
        freed = 0
        while freed < need:
            with self._lock:
                if len(self._resident) <= 1:
                    break
                victim, nb = self._resident.popitem(last=False)
                self._resident_weights.pop(victim, None)
                self.stats["evictions"] += 1
            self.budget.release(f"staged:{victim}", nb)
            freed += nb
        return freed

    @property
    def memory_budget_bytes(self) -> Optional[int]:
        """Live view over the shared pool's cap: assigning retunes
        ``budget.total`` (residency, packed params, and KV all share it),
        so operator code that always adjusted this attribute keeps
        working against the pooled accounting."""
        return self.budget.total

    @memory_budget_bytes.setter
    def memory_budget_bytes(self, v: Optional[int]) -> None:
        self.budget.total = None if v is None else int(v)

    def resident_models(self) -> List[str]:
        with self._lock:
            return list(self._resident)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._resident.values())

    def evict(self, name: str) -> bool:
        with self._lock:
            self._resident_weights.pop(name, None)
            nb = self._resident.pop(name, None)
        if nb is not None:
            self.budget.release(f"staged:{name}", nb)
        return nb is not None

    # -- warm-state transfer serving -------------------------------------------
    def resident_state_for_transfer(self, name: str, *, packed: bool = False):
        """The ``WarmStateServer``'s data source: ``(state, reason)`` where
        ``state`` is ``{layer: {key: tensor}}`` or None (refusal). The
        values are the resident staged tensors themselves; the server
        moves each to pinned host bytes as it sends it, so a transfer
        never holds a second whole-model host copy.

        Refuses rather than serves a partial answer when the model is not
        resident, the server is draining, the shared memory budget is
        overcommitted (serving a transfer materializes host copies —
        exactly the wrong moment to add pressure), or the operator flag
        ``refuse_transfers`` is set.  ``packed=True`` additionally rides
        the registered packed decode params under ``__packed__``."""
        with self._lock:
            if self.refuse_transfers:
                self.stats["transfer_refusals"] += 1
                return None, "refused by operator"
            if self._draining:
                self.stats["transfer_refusals"] += 1
                return None, "draining"
            weights = self._resident_weights.get(name)
            if weights is None:
                self.stats["transfer_refusals"] += 1
                return None, "not resident"
            state = {lname: dict(kv) for lname, kv in weights.items() if kv}
            if packed:
                pk = self._packed_state.get(name)
                if pk:
                    state[PACKED_LAYER] = dict(pk)
            self._resident.move_to_end(name)    # a transfer is a warm use
            self.stats["transfers_served"] += 1
        if self.budget.over_budget():
            with self._lock:
                self.stats["transfers_served"] -= 1
                self.stats["transfer_refusals"] += 1
            return None, "memory pressure"
        return state, "ok"

    def register_packed_state(self, name: str, params: Dict[str, Any]):
        """Packed decode-path params (the LLM bridge's ``pack`` output):
        kept servable over the warm-state channel under the reserved
        ``__packed__`` pseudo-layer, charged to the shared budget."""
        flat = {k: v for k, v in params.items()
                if getattr(v, "nbytes", None) is not None}
        if not flat:
            return
        nbytes = sum(int(v.nbytes) for v in flat.values())
        with self._lock:
            old = self._packed_state.pop(name, None)
            self._packed_state[name] = flat
        if old is not None:
            self.budget.release(f"packed:{name}")
        self.budget.reserve(f"packed:{name}", nbytes)

    # -- warm-run batching (front-door worker coalescing) --------------------
    def warm_run_many(self, name: str, xs: Sequence[Any]
                      ) -> Optional[List[RunResult]]:
        """Serve N queued same-model warm requests in ONE per-layer sweep:
        layer i's compiled executable runs N times back-to-back against the
        resident weights before moving to layer i+1 — the ``BatchedServer``
        drain pattern applied to warm CNN serving (icache/weight locality,
        one LRU touch, one stats update) instead of N serial ``warm_run``
        walks.  None = not resident (callers fall back to cold starts)."""
        if not xs:
            return []
        with self._lock:
            weights = self._resident_weights.get(name)
            if weights is None:
                return None
            self._resident.move_to_end(name)
            self.stats["warm_runs"] += len(xs)
            self.stats["warm_batches"] += 1
            self._served[name] = self._served.get(name, 0) + len(xs)
        eng = self.engines[name]
        rt = eng._runtime(n_little=self.n_little, work_stealing=True)
        t0 = time.perf_counter()
        stream = eng._stream
        ys = [to_device(x, eng.device, stream) for x in xs]
        with on_stream(stream):
            for lname in rt.order:
                fn = rt.jitted[lname]
                w = consume(weights.get(lname, {}), stream)
                ys = [fn(w, y) for y in ys]
        sync(stream)
        total = time.perf_counter() - t0
        return [RunResult(output=y, total_s=total, weights=weights)
                for y in ys]
