"""Online pipelined runtime — §3.1.3 / §3.3 at execution time.

Since PR 5 this module is a thin façade over the ``repro.executor``
subsystem: ``run`` compiles the scheduling ``Plan`` into a typed task graph
(``read → transform → stage → execute`` with per-layer deps and core
affinities — ``executor.graph.compile_plan``) and submits it to the
process-wide persistent ``CorePool``. The pool's big/little workers are
created once and reused across runs *and models*: the steady path performs
no thread creation, and an idle worker steals the tail of the prep queue
with the most remaining preparation time (§3.3, the same
``pick_steal_donor`` rule the scheduler's simulator models).

Preparation still ends with an explicit *stage* op (a host→device copy on
the device's copy stream, ``core.staging``): weights arrive on device as
part of prep, off the critical exec chain. With
``stage_in_prep=False`` staging is deferred to ``any``-affinity tasks —
whoever idles first stages layer i+1 while layer i executes (the old
dedicated "stager" threads are gone); ``prefetch=False`` pins deferred
staging to the big cores, strictly inline before each execute.

Every op's (start, end) is recorded per job for the benchmark breakdowns;
trace kinds are ``read`` / ``transform`` / ``stage`` / ``execute``.

On a CUDA device every execute runs on the runtime's own exec stream: it
waits on the layer's stage event, marks the staged tensors as used on that
stream, and synchronizes before the task ends, so ``total_s`` stays the
wall time to a finished output.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.registry import Kernel, LayerSpec
from repro_torch.core.scheduler import Plan
from repro_torch.core.staging import consume, stage_weights
from repro_torch.device import as_device, new_stream, on_stream, sync, to_device
from repro_torch.executor.graph import OpTrace, compile_plan
from repro_torch.executor.pool import CorePool, Job, get_core_pool
from repro_torch.faults import TransientFault
from repro_torch.ioengine import ReadAbandoned

__all__ = ["OpTrace", "PipelineJob", "PipelineRuntime", "RunResult"]


@dataclass
class RunResult:
    output: Any
    total_s: float
    traces: List[OpTrace] = field(default_factory=list)
    weights: Optional[Dict[str, Any]] = None  # resident post-run weights
    # readahead coverage of this run ({"mode", "layers_requested",
    # "layers_hinted", "bytes_hinted", ...}); None when the runtime issued
    # no hint at all — benchmark breakdowns use this to tell hinted runs
    # from ones where the hint silently no-oped (e.g. no madvise)
    readahead: Optional[Dict[str, Any]] = None

    def stage_seconds(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for t in self.traces:
            agg[t.kind] = agg.get(t.kind, 0.0) + (t.end - t.start)
        return agg


class PipelineJob:
    """Handle for one in-flight cold run submitted to the pool."""

    def __init__(self, job: Job, state: Dict[str, Any],
                 weights: Dict[str, Any],
                 readahead: Optional[Dict[str, Any]] = None):
        self.job = job
        self._state = state
        self._weights = weights
        self._readahead = readahead

    @property
    def t0(self) -> float:
        return self.job.t0

    @property
    def traces(self) -> List[OpTrace]:
        return self.job.traces

    def done(self) -> bool:
        return self.job.done.is_set()

    def result(self, timeout: Optional[float] = None) -> RunResult:
        self.job.wait(timeout)
        return RunResult(output=self._state["y"], total_s=self.job.total_s,
                         traces=self.job.traces, weights=self._weights,
                         readahead=self._readahead)


class _AsyncReads:
    """Per-job submit/reap ledger over the async I/O engine.

    Submissions are keyed by layer and idempotent, so the depth-prefetch
    a read task issues for its lane successors composes with work
    stealing (whoever ends up running a stolen layer's read reaps the
    same pending handle).  Pending handles self-reset on transient
    faults, so the pool's bounded retries resubmit cleanly; pool buffers
    recycle at job end via ``close()`` (a ``Job.add_done_callback``),
    the first moment no retry or zombie attempt can still need the
    views."""

    def __init__(self, runtime: "PipelineRuntime", engine):
        self.rt = runtime
        self.engine = engine
        self.lock = threading.Lock()
        self.pending: Dict[str, Any] = {}
        self.closed = False
        self.prefetched = 0
        self.prefetch_bytes = 0

    def _submit_locked(self, layer: str):
        if layer in self.pending or self.closed:
            return self.pending.get(layer)
        rt = self.rt
        if not rt.specs[layer].weight_shapes:
            return None
        if rt.use_cache.get(layer, False):
            h = rt.store.submit_read_cached(self.engine, layer,
                                            rt.kernels[layer].name)
        else:
            h = rt.store.submit_read_raw(self.engine, layer)
        self.pending[layer] = h
        return h

    def prefetch(self, layers) -> None:
        """Best-effort submissions for upcoming layers (depth readahead).
        Failures are swallowed: the layer's own read task resubmits with
        the pool's retry budget when its turn comes."""
        for name in layers:
            try:
                with self.lock:
                    before = name in self.pending
                    h = self._submit_locked(name)
                if h is not None and not before:
                    self.prefetched += 1
                    self.prefetch_bytes += h.nbytes()
            except Exception:
                continue

    def wait(self, layer: str):
        with self.lock:
            h = self._submit_locked(layer)
        if h is None:
            return {}
        return h.wait()

    def abort(self, layer: str) -> None:
        """Race-loser interrupt: flag the layer's in-flight read abandoned
        so a waiter parked in the engine's emulated-disk pacing raises
        ``ReadAbandoned`` and frees its pool slot now. Flag-only — buffer
        recycling still happens at job-end ``close()``."""
        with self.lock:
            h = self.pending.get(layer)
        ab = getattr(h, "abort", None)
        if ab is not None:
            ab()

    def close(self) -> None:
        with self.lock:
            self.closed = True
            handles = list(self.pending.values())
            self.pending.clear()
        for h in handles:
            h.release()


class PipelineRuntime:
    def __init__(
        self,
        specs: List[LayerSpec],
        kernels: Dict[str, Kernel],       # layer name -> chosen kernel
        use_cache: Dict[str, bool],
        store,
        jitted: Dict[str, Callable],      # layer name -> jitted exec fn
        n_little: int,
        work_stealing: bool = True,
        stage_in_prep: bool = True,
        prefetch: bool = True,
        prep_costs: Optional[Dict[str, float]] = None,
        pool: Optional[CorePool] = None,
        retry=None,                       # faults.RetryPolicy for the job
        deadline_s: Optional[float] = None,  # per-task watchdog deadline
        fault_injector=None,              # faults.FaultInjector (chaos)
        repair_log=None,                  # faults.RepairLog (ladder events)
        fallback_exec: Optional[Callable] = None,  # (layer, x, exc) -> y
        exec_allowed: Optional[Callable[[str], bool]] = None,  # breaker
        io_engine=None,                   # repro.ioengine.IOEngine (async
                                          # submit/reap reads; None = sync)
        stage_engine=None,                # repro.ioengine.StageEngine
        device="cuda",
    ):
        self.specs = {s.name: s for s in specs}
        self.order = [s.name for s in specs]
        self.kernels = kernels
        self.use_cache = use_cache
        self.store = store
        self.jitted = jitted
        self.n_little = n_little
        self.work_stealing = work_stealing
        self.stage_in_prep = stage_in_prep
        self.prefetch = prefetch
        self.pool = pool
        self.retry = retry
        self.deadline_s = deadline_s
        self.fault_injector = fault_injector
        self.repair_log = repair_log
        self.fallback_exec = fallback_exec
        self.exec_allowed = exec_allowed
        # async reads go through the engine only when the store's format
        # supports extent submission (npy legacy stays sync by design)
        self.io_engine = (io_engine if io_engine is not None
                          and getattr(store, "supports_async", False)
                          else None)
        self.stage_engine = stage_engine
        self.device = as_device(device)
        self.exec_stream = new_stream(self.device)
        # per-layer prep-cost estimates drive donor selection when stealing;
        # weight bytes are the fallback proxy when no profile is plumbed in
        self.prep_costs = prep_costs or {
            s.name: float(s.weight_bytes) for s in specs}

    # -- device staging (the prep tail) -------------------------------------
    def _device_put(self, w):
        return stage_weights(w, self.device)

    def _stage(self, w):
        if self.stage_engine is not None:
            return self.stage_engine.stage(w, self.device)
        return self._device_put(w)

    def _exec(self, name: str, w, x):
        """One layer's execute on the exec stream, finished before return."""
        with on_stream(self.exec_stream):
            consume(w, self.exec_stream)
            y = self.jitted[name](w, x)
        sync(self.exec_stream)
        return y

    def _fallback(self, name: str, x, exc):
        """The degradation ladder's execute, on the exec stream (the engine's
        fallback synchronizes the stream before it returns)."""
        with on_stream(self.exec_stream):
            return self.fallback_exec(name, x, exc)

    def _get_pool(self) -> CorePool:
        if self.pool is None:
            self.pool = get_core_pool(n_little=self.n_little)
        return self.pool

    def _hint_readahead(self, layers: List[str]):
        """Super-bundle stores can madvise(WILLNEED) the extents the plan
        touches first, so kernel readahead runs ahead of the prep threads."""
        ra = getattr(self.store, "readahead", None)
        if ra is None:
            return
        seen, first = set(), []
        for n in layers:
            if n not in seen:
                seen.add(n)
                first.append(n)
        ra(first)

    # -- one preparation op (read [+ transform] + stage) --------------------
    # kept whole for callers that prep a single layer synchronously (tests,
    # fallback paths); the task graph uses the finer-grained ops below
    def _prepare(self, layer: str, weights_out: Dict[str, Any],
                 traces: List[OpTrace], core: str, t0: float, lock,
                 staged: Optional[Dict[str, threading.Event]] = None):
        spec = self.specs[layer]
        if not spec.weight_shapes:
            with lock:
                weights_out[layer] = {}
            if staged is not None:
                staged[layer].set()
            return
        if self.use_cache.get(layer, False):
            ts = time.perf_counter()
            w = self._read_op(layer)
            te = time.perf_counter()
            traces.append(OpTrace(layer, "read", core, ts - t0, te - t0))
        else:
            ts = time.perf_counter()
            raw = self.store.read_raw(layer)
            tm = time.perf_counter()
            w = self.kernels[layer].transform(raw, spec)
            te = time.perf_counter()
            traces.append(OpTrace(layer, "read", core, ts - t0, tm - t0))
            traces.append(OpTrace(layer, "transform", core, tm - t0, te - t0))
        if self.stage_in_prep and staged is not None:
            ts = time.perf_counter()
            w = self._device_put(w)
            traces.append(OpTrace(layer, "stage", core, ts - t0,
                                  time.perf_counter() - t0))
            with lock:
                weights_out[layer] = w
            staged[layer].set()
        else:
            with lock:
                weights_out[layer] = w

    def _read_op(self, layer: str):
        """The 'read' task body: cached entry (§3.1.2) or raw weights.

        Degradation ladder, first rung: the cache entry is CRC-audited
        before it is trusted (``LayerStore.audit_cached`` covers the
        zero-copy mmap path that lazy verification normally skips). A
        failing or missing entry is transparently recomputed from raw and
        the repair is journaled — the request never fails over bit-rot."""
        spec = self.specs[layer]
        kern = self.kernels[layer]
        if self.use_cache.get(layer, False):
            audit = getattr(self.store, "audit_cached", None)
            ok = audit(layer, kern.name) if audit is not None else True
            w = self.store.read_cached(layer, kern.name) if ok else {}
            if not w:
                # dropped under the plan's feet (journal recovery, checksum
                # audit, bit-rot): recompute rather than execute weightless
                w = kern.transform(self.store.read_raw(layer), spec)
                if self.repair_log is not None:
                    self.repair_log.record(
                        "cache_recompute", layer=layer, kernel=kern.name,
                        reason=("failed CRC audit" if not ok
                                else "entry missing/dropped"))
            return w
        return self.store.read_raw(layer)

    def _read_op_async(self, reads: _AsyncReads, layer: str):
        """Async 'read' task body: reap the layer's pending submission.

        Same degradation ladder as ``_read_op`` — the CRC audit runs on
        the reaped bytes inside the pending read (covering exactly the
        bytes served), and a dropped/missing cache entry recomputes from
        raw with the repair journaled."""
        w = reads.wait(layer)
        if self.use_cache.get(layer, False) and not w:
            spec = self.specs[layer]
            kern = self.kernels[layer]
            if spec.weight_shapes:
                w = kern.transform(self.store.read_raw(layer), spec)
                if self.repair_log is not None:
                    self.repair_log.record(
                        "cache_recompute", layer=layer, kernel=kern.name,
                        reason="entry missing/dropped (async read)")
        return w

    # -- graph compilation + submission -------------------------------------
    def submit(self, x, plan: Plan, *, graph_hook=None,
               job_deadline_s: Optional[float] = None,
               peer_fetch=None) -> PipelineJob:
        """Compile the plan into a task graph and hand it to the persistent
        pool; returns immediately with a :class:`PipelineJob`.

        ``graph_hook(graph, weights, lock)`` may append extra tasks (e.g.
        the LLM bridge's decode-path packing) before submission.
        ``job_deadline_s`` is the run's END-TO-END budget: the pool
        watchdog fails the job with a typed ``DeadlineExceeded`` once it is
        blown (the front door's deadline propagation lands here).

        ``peer_fetch`` (a ``warmstate.PeerFetcher``) arms the warm-state
        race: the peer's post-transform staged weights stream in on the
        fetcher's own background thread (started at submit, so the wire
        races the disk from t=0), each layer racing its local
        ``read → transform → stage`` chain.  First finisher wins — the
        winner cancels the loser via ``CorePool.cancel_tasks`` (preps-done
        still fires exactly once); every weighted layer also gets a
        dep-free ``fetch_remote`` marker task so the race is visible and
        cancellable in the DAG.  A peer-landed layer goes through the same
        stage path as a local one, so both are bit-identical.  Any
        ``TransientFault`` on the wire falls back to the local chains
        without failing the job.  Every outcome lands in the job's
        ``fault_events`` journal."""
        t0 = time.perf_counter()
        weights: Dict[str, Any] = {
            n: {} for n in self.order if not self.specs[n].weight_shapes}
        pending: Dict[str, Any] = {}     # intra-chain intermediates
        lock = threading.Lock()
        state: Dict[str, Any] = {
            "y": to_device(x, self.device, self.exec_stream)}

        queues = [[self.order[i] for i in q] for q in plan.little_queues]
        hint_layers = (
            [q[0] for q in queues if q]
            + [self.order[i] for i in plan.big_prep]
            + self.order[: 2 * (len(queues) + 1)])

        reads = (_AsyncReads(self, self.io_engine)
                 if self.io_engine is not None else None)
        ra_stats: Optional[Dict[str, Any]] = None
        if reads is not None:
            # readahead hints route through the engine: the plan's first
            # layers are submitted NOW, so their bytes are moving before
            # any worker picks up a read task (the async analogue of the
            # madvise hint, and counted the same way)
            seen: set = set()
            first = [n for n in hint_layers
                     if not (n in seen or seen.add(n))]
            reads.prefetch(first)
            ra_stats = {"mode": "engine", "layers_requested": len(first),
                        "layers_hinted": reads.prefetched,
                        "bytes_hinted": reads.prefetch_bytes,
                        "madvise_available": False}
        else:
            self._hint_readahead(hint_layers)
            st = getattr(self.store, "readahead_stats", None)
            if st is not None:
                ra_stats = {"mode": "madvise", **st}
        fetch_layers = None
        if peer_fetch is not None:
            fetch_layers = [n for n in self.order
                            if self.specs[n].weight_shapes]

        graph = compile_plan(
            self.order, plan,
            weighted={n: bool(self.specs[n].weight_shapes)
                      for n in self.order},
            use_cache=self.use_cache,
            prep_costs=self.prep_costs,
            stage_in_prep=self.stage_in_prep,
            deferred_stage_affinity="any" if self.prefetch else "big",
            fetch_layers=fetch_layers,
        )
        # race bookkeeping: the winner cancels the loser by tid.  jobref is
        # a late-bound cell — task fns can start before ``pool.submit``
        # returns the Job; a miss in that window just means both sides run
        # to completion and stage bit-identical weights (the first kept).
        # Race journal lines from that window wait in ``early`` until the
        # Job exists.
        jobref: List[Optional[Job]] = [None]
        early: List[Dict[str, Any]] = []

        def journal(event):
            with lock:
                job = jobref[0]
                if job is None:
                    early.append(event)
                    return
            job.fault_events.append(event)

        chain_tids: Dict[str, List[int]] = {
            n: [t.tid for t in ts] for n, ts in graph.prep_chains().items()}
        fetch_tids: Dict[str, int] = {
            t.layer: t.tid for t in graph.tasks if t.kind == "fetch_remote"}
        # lane successors for depth prefetch: a read task submits its own
        # layer plus the next (depth-1) layers of its lane, so a little
        # core keeps Plan.read_depth reads in flight instead of one
        succ: Dict[str, List[str]] = {}
        if reads is not None:
            seqs = list(graph.lane_queues().values())
            seqs.append(graph.big_prep_layers())
            for seq in seqs:
                for i, n in enumerate(seq):
                    succ[n] = seq[i + 1:]

        # task fns are VALUE-IDEMPOTENT: every stage writes its own
        # (name, kind) key instead of mutating/popping a shared one, so a
        # retried attempt — or a watchdog-zombie that finishes late —
        # recomputes the identical value into the same slot and cannot
        # corrupt the chain. (Intermediates are held until the job ends;
        # the pool-retry safety is worth the transient footprint.)
        def read_fn(name, depth=1):
            if reads is None:
                def fn():
                    pending[(name, "read")] = self._read_op(name)
                return fn

            ahead = succ.get(name, [])[:max(0, depth - 1)]

            def fn():
                reads.prefetch(ahead)   # keep the lane at planned depth
                try:
                    pending[(name, "read")] = self._read_op_async(reads,
                                                                  name)
                except ReadAbandoned:
                    # warm-state fetch won this layer mid-read: the chain's
                    # later tasks are already cancelled — bail, freeing the
                    # slot instead of sleeping out the emulated disk
                    return
            return fn

        def fetch_won(name):
            """The peer landed this layer while its local read was
            abandoned: the chain's remaining tasks have nothing to do."""
            with lock:
                return name in weights

        def transform_fn(name):
            def fn():
                if (name, "read") not in pending and fetch_won(name):
                    return
                pending[(name, "xf")] = self.kernels[name].transform(
                    pending[(name, "read")], self.specs[name])
            return fn

        def stage_fn(name):
            def fn():
                src = pending.get((name, "xf"), None)
                if src is None:
                    if (name, "read") not in pending and fetch_won(name):
                        return
                    src = pending[(name, "read")]
                w = self._stage(src)
                with lock:
                    won = name not in weights
                    if won:
                        weights[name] = w
                # local chain finished first: retire the pending fetch task
                # (a RUNNING fetch is left alone — it re-checks ``weights``
                # before writing, and both values are bit-identical anyway)
                ftid = fetch_tids.get(name)
                if won and ftid is not None:
                    job = jobref[0]
                    if job is not None:
                        self._get_pool().cancel_tasks(
                            job, [ftid], reason="race_local_won")
            return fn

        # The peer stream drains on the PeerFetcher's OWN thread (started
        # eagerly below, like the read prefetch — bytes are moving before
        # any worker picks up a task) and delivers layers through these
        # callbacks; the graph's ``fetch_remote`` tasks are the race's
        # instant, cancellable markers (running one backstop-starts the
        # stream; a local win retires its layer's pending marker).  The
        # stream NEVER fails the job: any TransientFault (refusal,
        # disconnect, CRC mismatch, injected chaos at the warmstate.*
        # sites) journals a fallback and leaves the local chains — always
        # racing — authoritative.
        def fetch_landed(name, w):
            with lock:
                lost = name in weights           # local chain already won
            if not lost:
                staged = self._stage(w)
                with lock:
                    lost = name in weights       # ...or won while we staged
                    if not lost:
                        weights[name] = staged
            journal({"action": "fetch_lost" if lost else "fetch_won",
                     "layer": name})
            if lost:
                return
            job = jobref[0]
            # fetch won: retire the local read→transform→stage chain;
            # cancellation fires preps-done through the pool's
            # exactly-once accounting. A read task already RUNNING can't
            # be cancelled — interrupt its (emulated-disk) wait instead
            if job is None:
                return      # no cancel yet: the local chain runs out
            self._get_pool().cancel_tasks(
                job, chain_tids.get(name, ()), reason="race_fetch_won")
            if reads is not None:
                reads.abort(name)

        def fetch_failed(e):
            journal({"action": "fetch_fallback",
                     "error": type(e).__name__, "detail": str(e)})
            if self.repair_log is not None:
                self.repair_log.record(
                    "fetch_fallback", error=type(e).__name__)

        def race_decided():
            with lock:
                return all(n in weights for n in (fetch_layers or ()))

        def fetch_fn(name):
            def fn():
                peer_fetch.start_stream(fetch_landed, on_error=fetch_failed,
                                        should_stop=race_decided)
            return fn

        def execute_fn(name):
            def fn():
                with lock:
                    w = weights.get(name, {})
                x_in = state["y"]
                if (self.fallback_exec is not None
                        and self.exec_allowed is not None
                        and not self.exec_allowed(name)):
                    # circuit breaker already open for this layer's kernel:
                    # demote straight to the reference path
                    y = self._fallback(name, x_in, None)
                else:
                    try:
                        inj = self.fault_injector
                        if inj is not None:
                            inj.maybe_fault("kernel.execute", name)
                        y = self._exec(name, w, x_in)
                    except TransientFault:
                        raise  # pool-level bounded retry (state["y"] is
                        #        untouched, so the retry reads the same x)
                    except Exception as e:
                        if self.fallback_exec is None:
                            raise
                        # degradation ladder: a faulting kernel demotes to
                        # the reference kernel instead of failing the run
                        y = self._fallback(name, x_in, e)
                state["y"] = y
            return fn

        binders = {"read": read_fn, "transform": transform_fn,
                   "stage": stage_fn, "execute": execute_fn,
                   "fetch_remote": fetch_fn}
        for task in graph.tasks:
            if task.kind == "read":
                task.fn = read_fn(task.layer, task.depth)
            else:
                task.fn = binders[task.kind](task.layer)
        if graph_hook is not None:
            graph_hook(graph, weights, lock)

        if peer_fetch is not None and fetch_layers:
            # arm the race NOW — the peer stream races the disk from t=0,
            # not from whenever a pool worker first idles
            peer_fetch.start_stream(fetch_landed, on_error=fetch_failed,
                                    should_stop=race_decided)

        job = self._get_pool().submit(
            graph, name=f"cold:{self.order[0]}..{self.order[-1]}",
            allow_steal=self.work_stealing, t0=t0,
            retry=self.retry, deadline_s=self.deadline_s,
            job_deadline_s=job_deadline_s)
        with lock:
            jobref[0] = job
            job.fault_events.extend(early)
        if reads is not None:
            # engine buffers recycle only once no retry/zombie can still
            # reap them — i.e. when the job is finished for good
            job.add_done_callback(lambda _j: reads.close())
        if peer_fetch is not None:
            def _end_race(j):
                peer_fetch.close()
                # journal the race's closing line next to the per-layer
                # win/loss/fallback events
                j.fault_events.append({
                    "action": "fetch_race_end",
                    **{k: peer_fetch.stats[k]
                       for k in ("layers_fetched", "bytes_fetched",
                                 "crc_failures", "refused")}})
            job.add_done_callback(_end_race)
        return PipelineJob(job, state, weights, readahead=ra_stats)

    def run(self, x, plan: Plan) -> RunResult:
        return self.submit(x, plan).result()

    # -- baseline: fully sequential cold inference (ncnn-like) --------------
    def run_sequential(self, x, kernels: Optional[Dict[str, Kernel]] = None) -> RunResult:
        kernels = kernels or self.kernels
        t0 = time.perf_counter()
        traces: List[OpTrace] = []
        weights: Dict[str, Any] = {}
        self._hint_readahead(self.order)
        for name in self.order:           # read all
            ts = time.perf_counter()
            # mmap=False: the ncnn-like baseline's read op must move the
            # layer's bytes off the disk — a lazy mmap view would make the
            # 'read' trace metadata-only and silently shift the disk cost
            # into transform/stage, corrupting the breakdown
            weights[name] = (self.store.read_raw(name, mmap=False)
                             if self.specs[name].weight_shapes else {})
            traces.append(OpTrace(name, "read", "big", ts - t0, time.perf_counter() - t0))
        for name in self.order:           # transform all
            if not self.specs[name].weight_shapes:
                continue
            ts = time.perf_counter()
            weights[name] = kernels[name].transform(weights[name], self.specs[name])
            traces.append(OpTrace(name, "transform", "big", ts - t0, time.perf_counter() - t0))
        for name in self.order:           # stage all (host -> device)
            ts = time.perf_counter()
            weights[name] = self._device_put(weights[name])
            traces.append(OpTrace(name, "stage", "big", ts - t0, time.perf_counter() - t0))
        y = to_device(x, self.device, self.exec_stream)
        for name in self.order:           # execute all (device-resident weights)
            ts = time.perf_counter()
            y = self._exec(name, weights[name], y)
            traces.append(OpTrace(name, "execute", "big", ts - t0, time.perf_counter() - t0))
        st = getattr(self.store, "readahead_stats", None)
        return RunResult(output=y, total_s=time.perf_counter() - t0,
                         traces=traces,
                         readahead=({"mode": "madvise", **st}
                                    if st is not None else None))
