"""Persistent asymmetric core pools.

One process-wide ``CorePool`` holds the big/little worker threads the
pipelined runtime used to spawn per run. Threads are created once (the pool
grows on demand) and reused across runs *and models*: the steady cold-serving
path performs zero thread creation. Jobs — compiled ``TaskGraph``s — are
submitted concurrently; every task records an ``OpTrace`` against its own
job's clock, so traces and benchmark breakdowns stay strictly per-run.

Scheduling rules (mirroring the plan simulator, §3.3):

  * a little worker drains its own lane in order; when idle it *steals* —
    donor = the lane with the most remaining prep cost (the shared
    ``scheduler.pick_steal_donor`` rule), item = the donor's TAIL layer,
    whose whole prep chain is retargeted to the thief's lane;
  * big workers run ``big``-affinity tasks in tid order (the plan's big
    preps first, then the exec chain as its deps release);
  * ``any``-affinity tasks (deferred staging, background packing) go to
    whoever idles first — an idle little core prefetch-stages layer i+1
    while the big core executes layer i, without a dedicated stager thread.

Fault domain (``repro.faults``):

  * a task raising a ``TransientFault`` is retried in place — bounded by the
    job's ``RetryPolicy``, with exponential backoff enforced through a
    per-task ``not_before`` eligibility time (workers skip ineligible tasks
    and sleep until the earliest backoff expires). Any other exception still
    fails the job exactly as before.
  * tasks may carry a deadline (per-task ``Task.deadline_s`` or the job-wide
    ``deadline_s=`` given at submit). A watchdog thread (started lazily the
    first time a deadline is used — the deadline-free steady path never pays
    for it) expires overdue tasks: the stuck worker is retired (quarantined)
    and replaced by a fresh thread for the same lane, the lane's unstarted
    prep chains are rescheduled onto healthy lanes via the steal rule's cost
    metric, and the expired *prep* task is retried on a healthy lane (an
    overdue *execute* task fails the job with ``DeadlineExceeded`` — the
    activation chain is stateful, so re-running it behind a live zombie
    could corrupt ``state["y"]``). Per-task epoch counters make the zombie's
    eventual completion harmlessly discardable.
  * ``shutdown()`` detects workers that never joined (a hung task leaks the
    thread), counts them in ``health["workers_lost"]`` and reports (or
    raises, with ``raise_on_leak=True``) a typed ``WorkerLost``.
  * ``health`` counts retries/expiries/quarantines/leaks pool-wide;
    ``Job.retries`` and ``Job.fault_events`` record the per-run story.

A failing task cancels the rest of its job (other jobs are untouched) and
re-raises from ``Job.result()``/``wait()``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.scheduler import pick_steal_donor
from repro_torch.executor.graph import OpTrace, PREP_KINDS, TaskGraph
from repro_torch.faults import (
    DEFAULT_RETRY, DeadlineExceeded, JobTimeout, RetryPolicy, TransientFault,
    WorkerLost, classify,
)

_PENDING, _READY, _RUNNING, _DONE, _CANCELLED = range(5)

#: platform support for per-thread CPU affinity (Linux). Everything pinning
#: does is gated on this flag so other platforms get a clean no-op.
_HAS_AFFINITY = hasattr(os, "sched_setaffinity") \
    and hasattr(os, "sched_getaffinity")


def _pin_current_thread(cpus: Set[int]) -> bool:
    """Pin the calling thread to ``cpus``; False on any failure (no-op
    fallback — pinning is a locality optimization, never a correctness
    requirement)."""
    if not _HAS_AFFINITY or not cpus:
        return False
    try:
        os.sched_setaffinity(0, cpus)   # tid 0 = the calling thread
        return True
    except OSError:
        return False


_JOB_SEQ = itertools.count(1)


class Job:
    """One submitted task graph: per-run traces, completion event, error."""

    def __init__(self, graph: TaskGraph, name: str, t0: Optional[float],
                 allow_steal: bool, retry: Optional[RetryPolicy] = None,
                 deadline_s: Optional[float] = None,
                 job_deadline_s: Optional[float] = None):
        self.seq = next(_JOB_SEQ)
        self.graph = graph
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.allow_steal = allow_steal
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self.deadline_s = deadline_s  # job-wide default task deadline
        self.job_deadline_s = job_deadline_s  # end-to-end budget for the
        #                                       WHOLE job (measured from t0);
        #                                       the watchdog fails the job
        #                                       typed once it is blown
        self.traces: List[OpTrace] = []
        self.total_s: float = 0.0
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.retries = 0                      # transient-fault retries used
        self.fault_events: List[dict] = []    # per-run fault/retry story
        self.on_preps_done: List[Callable[["Job"], None]] = []
        self.on_done: List[Callable[["Job"], None]] = []
        self._cb_lock = threading.Lock()
        self._done_cb_fired = False

        n = len(graph.tasks)
        self._state = [_PENDING] * n
        self._pending = [len(t.deps) for t in graph.tasks]
        self._children: List[List[int]] = [[] for _ in range(n)]
        for t in graph.tasks:
            for d in t.deps:
                self._children[d].append(t.tid)
        self._done_count = 0
        self._attempts = [0] * n            # transient retries consumed
        self._epoch = [0] * n               # bumped when the watchdog expires
        #                                     a running attempt: the zombie's
        #                                     eventual completion is discarded
        self._not_before: Dict[int, float] = {}  # backoff eligibility times
        self._prep_left = sum(
            1 for t in graph.tasks if t.kind in PREP_KINDS)
        # prep-free jobs have no worker to fire preps-done: treat the prep
        # phase as already over, so late-registered callbacks run inline
        self._preps_fired = self._prep_left == 0
        self._preps_cb_fired = self._preps_fired
        # ready lists per affinity; little lanes also track layer order and
        # remaining (unstarted) cost for the steal-donor rule
        self._ready_big: List[int] = []
        self._ready_any: List[int] = []
        self._ready_little: Dict[int, List[int]] = {}
        self._lane_layers: Dict[int, List[str]] = {}
        self._layer_chain: Dict[str, List[int]] = {}
        for t in graph.tasks:
            if t.affinity == "little" and t.kind in PREP_KINDS:
                lane = self._lane_layers.setdefault(t.lane, [])
                if t.layer not in lane:
                    lane.append(t.layer)
                self._layer_chain.setdefault(t.layer, []).append(t.tid)
        # a job is served by exactly the little lanes its plan scheduled —
        # a wider pool must not hand a run more little cores than the
        # plan's makespan modeled (extra workers still help with 'any'
        # tasks and other jobs)
        lanes = graph.lanes()
        self.n_lanes = (max(lanes) + 1) if lanes else 0
        for t in graph.tasks:
            if self._pending[t.tid] == 0:
                self._mark_ready(t.tid)

    # -- internal (all called under the pool lock) --------------------------
    def _mark_ready(self, tid: int):
        t = self.graph.tasks[tid]
        self._state[tid] = _READY
        if t.affinity == "big":
            self._ready_big.append(tid)
        elif t.affinity == "any":
            self._ready_any.append(tid)
        else:
            self._ready_little.setdefault(t.lane, []).append(tid)

    def _lane_remaining(self, now: Optional[float] = None
                        ) -> Dict[int, List[str]]:
        """Per lane: layers whose prep chain has not started (stealable).
        With ``now`` given, chains whose head is still in retry backoff are
        excluded (not worth stealing yet)."""
        out: Dict[int, List[str]] = {}
        for lane, layers in self._lane_layers.items():
            ls = [n for n in layers
                  if self._state[self._layer_chain[n][0]] == _READY
                  and (now is None
                       or self._not_before.get(
                           self._layer_chain[n][0], 0.0) <= now)]
            if ls:
                out[lane] = ls
        return out

    def _chain_cost(self, layer: str) -> float:
        return self.graph.tasks[self._layer_chain[layer][0]].cost

    def _move_layer(self, layer: str, to_lane: int):
        """Retarget one layer's unstarted prep chain to ``to_lane``."""
        for tid in self._layer_chain[layer]:
            t = self.graph.tasks[tid]
            if self._state[tid] == _READY:
                self._ready_little[t.lane].remove(tid)
                self._ready_little.setdefault(to_lane, []).append(tid)
            t.lane = to_lane
        for lane, layers in self._lane_layers.items():
            if layer in layers and lane != to_lane:
                layers.remove(layer)
                break
        self._lane_layers.setdefault(to_lane, []).append(layer)

    def _requeue_from_lane(self, lane: int) -> int:
        """Move every unstarted prep chain off ``lane`` onto the least-
        loaded other lane — the steal rule's remaining-cost metric, inverted
        (send work to the emptiest healthy lane). Called by the pool
        watchdog when a lane's worker is quarantined."""
        if self.n_lanes <= 1 or lane >= self.n_lanes:
            return 0
        moved = 0
        while True:
            remaining = self._lane_remaining()
            layers = remaining.get(lane)
            if not layers:
                return moved
            loads = {j: sum(self._chain_cost(n)
                            for n in remaining.get(j, []))
                     for j in range(self.n_lanes) if j != lane}
            dest = min(loads, key=lambda j: (loads[j], j))
            self._move_layer(layers[0], dest)
            moved += 1

    def _finished(self) -> bool:
        return self._done_count >= len(self.graph.tasks)

    # -- public -------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> "Job":
        if not self.done.wait(timeout):
            raise JobTimeout(
                f"job {self.name!r} still running after {timeout}s wait")
        if self.error is not None:
            raise self.error
        return self

    def preps_done(self) -> bool:
        return self._preps_fired

    def add_preps_callback(self, cb: Callable[["Job"], None]) -> None:
        """Register a preps-done callback; runs immediately if the job's
        prep phase already finished (registration is race-free w.r.t. the
        worker that fires the callbacks)."""
        with self._cb_lock:
            if not self._preps_cb_fired:
                self.on_preps_done.append(cb)
                return
        cb(self)

    def _fire_preps_callbacks(self):
        with self._cb_lock:
            self._preps_cb_fired = True
            cbs = list(self.on_preps_done)
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb: Callable[["Job"], None]) -> None:
        """Register a job-completion callback (success, failure, or
        watchdog expiry alike); runs immediately if the job already
        finished. The executor uses this to recycle async-read buffers —
        task values are held until job end for retry idempotency, so this
        is the first moment recycling is safe. Same race-free registration
        discipline as ``add_preps_callback``."""
        with self._cb_lock:
            if not self._done_cb_fired:
                self.on_done.append(cb)
                return
        cb(self)

    def _fire_done(self):
        """Fire done-callbacks then set the event — every completion path
        (worker finish, failure cancel, watchdog expiry, empty graph) goes
        through here, outside the pool lock."""
        with self._cb_lock:
            self._done_cb_fired = True
            cbs = list(self.on_done)
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass  # cleanup callbacks must not mask the job's outcome
        self.done.set()


def _pop_eligible(job: Job, lst: List[int], now: float) -> Optional[int]:
    """Pop the lowest eligible tid (backoff ``not_before`` respected)."""
    best = None
    for i, tid in enumerate(lst):
        if job._not_before.get(tid, 0.0) > now:
            continue
        if best is None or tid < lst[best]:
            best = i
    return lst.pop(best) if best is not None else None


class CorePool:
    """Persistent big.LITTLE worker pools executing task graphs."""

    def __init__(self, n_big: int = 1, n_little: int = 3,
                 name: str = "corepool", *,
                 watchdog_interval_s: float = 0.02,
                 pin_cores: bool = False):
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._jobs: List[Job] = []
        self._shutdown = False
        self._draining = False
        self.threads_created = 0
        self.jobs_completed = 0
        self.steals = 0
        # big/little lane pinning (sched_setaffinity where available): big
        # workers take the high-numbered cores, little lanes the low ones —
        # the big.LITTLE enumeration convention — wrapping when workers
        # outnumber cores. ``pinned`` records what each worker actually got
        # (None = the clean no-op fallback fired).
        self.pin_cores = bool(pin_cores)
        self.pinned: Dict[str, Optional[List[int]]] = {}
        # fault-domain state
        self.health: Dict[str, int] = {
            "task_retries": 0, "deadline_expired": 0,
            "job_deadline_expired": 0,
            "lanes_quarantined": 0, "workers_replaced": 0,
            "workers_lost": 0, "jobs_failed": 0, "tasks_cancelled": 0,
        }
        self.fault_injector = None  # repro.faults.FaultInjector ("task.*")
        self.watchdog_interval_s = watchdog_interval_s
        self.leak_report: Optional[dict] = None
        self._running: Dict[Tuple[int, int], dict] = {}  # (id(job), tid)
        self._retired: set = set()          # quarantined worker threads
        self._zombies: List[threading.Thread] = []
        self._watchdog: Optional[threading.Thread] = None
        self._big: List[threading.Thread] = []
        self._little: List[threading.Thread] = []
        self.ensure(n_little=n_little, n_big=n_big)

    @property
    def n_big(self) -> int:
        return len(self._big)

    @property
    def n_little(self) -> int:
        return len(self._little)

    def ensure(self, n_little: Optional[int] = None,
               n_big: Optional[int] = None) -> "CorePool":
        """Grow (never shrink) the worker sets. Idempotent; the steady
        serving path calls this with sizes the pool already has, creating
        zero threads."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("pool is shut down")
            while n_big is not None and len(self._big) < n_big:
                i = len(self._big)
                th = threading.Thread(
                    target=self._big_loop, args=(i,), daemon=True,
                    name=f"{self.name}-big{i}")
                self._big.append(th)
                self.threads_created += 1
                th.start()
            while n_little is not None and len(self._little) < n_little:
                j = len(self._little)
                th = threading.Thread(
                    target=self._little_loop, args=(j,), daemon=True,
                    name=f"{self.name}-little{j}")
                self._little.append(th)
                self.threads_created += 1
                th.start()
        return self

    def submit(self, graph: TaskGraph, *, name: str = "job",
               allow_steal: bool = True, t0: Optional[float] = None,
               retry: Optional[RetryPolicy] = None,
               deadline_s: Optional[float] = None,
               job_deadline_s: Optional[float] = None) -> Job:
        graph.validate()
        for t in graph.tasks:
            if t.fn is None:
                raise ValueError(
                    f"task {t.layer}/{t.kind} has no bound fn")
        lanes = graph.lanes()
        self.ensure(n_little=(max(lanes) + 1 if lanes else None), n_big=1)
        job = Job(graph, name, t0, allow_steal, retry, deadline_s,
                  job_deadline_s)
        needs_watchdog = (deadline_s is not None
                          or job_deadline_s is not None
                          or any(t.deadline_s is not None
                                 for t in graph.tasks))
        with self._cv:
            if self._shutdown:
                raise RuntimeError("pool is shut down")
            if self._draining:
                raise RuntimeError("pool is draining")
            if needs_watchdog and self._watchdog is None:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name=f"{self.name}-watchdog")
                self._watchdog.start()
            empty = job._finished()      # empty graph
            if empty:
                job.total_s = time.perf_counter() - job.t0
                self.jobs_completed += 1
            else:
                self._jobs.append(job)
                self._cv.notify_all()
        if empty:
            job._fire_done()
        return job

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop accepting new jobs (``submit`` raises) and
        wait for every in-flight job to finish. Returns True when the pool
        drained inside ``timeout`` (False = something is still running —
        the caller decides whether to escalate to ``shutdown``). Workers
        stay alive; ``resume()`` reopens submission."""
        with self._cv:
            self._draining = True
            jobs = list(self._jobs)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for job in jobs:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            if not job.done.wait(left):
                return False
        return True

    def resume(self) -> None:
        """Reopen submission after a ``drain`` (supervisor restart path)."""
        with self._cv:
            self._draining = False
            self._cv.notify_all()

    def shutdown(self, timeout: float = 5.0, *,
                 raise_on_leak: bool = False) -> dict:
        """Stop the pool. A worker stuck inside a hung task cannot join:
        such leaks are DETECTED (``health["workers_lost"]``, the returned
        report) instead of silently ignored, and raised as a typed
        ``WorkerLost`` when ``raise_on_leak`` is set."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        threads = list(self._big) + list(self._little) + list(self._zombies)
        if self._watchdog is not None:
            threads.append(self._watchdog)
        deadline = time.monotonic() + timeout
        leaked: List[str] = []
        for th in threads:
            th.join(timeout=max(deadline - time.monotonic(), 0.0))
            if th.is_alive():
                leaked.append(th.name)
        report: dict = {"leaked": leaked}
        if leaked:
            self.health["workers_lost"] += len(leaked)
            report["error"] = WorkerLost(
                f"{len(leaked)} pool worker(s) leaked at shutdown (hung "
                f"task?): {', '.join(leaked)}")
            self.leak_report = report
            if raise_on_leak:
                raise report["error"]
        return report

    # -- worker internals ----------------------------------------------------
    def _next_for_little(self, j: int, now: float
                         ) -> Optional[Tuple[Job, int]]:
        for job in self._jobs:
            rl = job._ready_little.get(j)
            if rl:
                tid = _pop_eligible(job, rl, now)
                if tid is not None:
                    return job, tid
        # steal: donor lane (any job that allows it) with most remaining
        # prep cost; take its tail layer's whole chain
        best: Optional[Tuple[Job, int, List[str]]] = None
        best_cost = 0.0
        for job in self._jobs:
            if not job.allow_steal or j >= job.n_lanes:
                continue
            remaining = job._lane_remaining(now)
            remaining.pop(j, None)      # own lane is empty (checked above)
            donor = pick_steal_donor(remaining, job._chain_cost)
            if donor is None:
                continue
            cost = sum(job._chain_cost(n) for n in remaining[donor])
            if best is None or cost > best_cost:
                best, best_cost = (job, donor, remaining[donor]), cost
        if best is not None:
            job, donor, layers = best
            job._move_layer(layers[-1], j)   # steal the tail
            self.steals += 1
            rl = job._ready_little.get(j)
            if rl:
                tid = _pop_eligible(job, rl, now)
                if tid is not None:
                    return job, tid
        for job in self._jobs:
            if job._ready_any:
                tid = _pop_eligible(job, job._ready_any, now)
                if tid is not None:
                    return job, tid
        return None

    def _next_for_big(self, now: float) -> Optional[Tuple[Job, int]]:
        for job in self._jobs:
            if job._ready_big:
                tid = _pop_eligible(job, job._ready_big, now)
                if tid is not None:
                    return job, tid
        for job in self._jobs:
            if job._ready_any:
                tid = _pop_eligible(job, job._ready_any, now)
                if tid is not None:
                    return job, tid
        return None

    def _wait_timeout(self, now: float) -> Optional[float]:
        """Sleep bound for an idle worker: until the earliest backoff-
        deferred READY task becomes eligible (None = no deferred work)."""
        nxt: Optional[float] = None
        for job in self._jobs:
            for tid, nb in job._not_before.items():
                if nb > now and job._state[tid] == _READY:
                    if nxt is None or nb < nxt:
                        nxt = nb
        return None if nxt is None else max(nxt - now, 1e-4)

    def _worker_loop(self, core: str,
                     pick: Callable[[float], Optional[Tuple[Job, int]]],
                     wkind: str, widx: int):
        me = threading.current_thread()
        while True:
            with self._cv:
                item = None
                while item is None:
                    if self._shutdown or me in self._retired:
                        return
                    now = time.perf_counter()
                    item = pick(now)
                    if item is None:
                        self._cv.wait(self._wait_timeout(now))
                job, tid = item
                job._state[tid] = _RUNNING
            self._run(job, tid, core, wkind, widx)

    # -- big/little lane pinning (satellite: NUMA/core locality) -------------
    def _cpuset_for(self, wkind: str, widx: int) -> Optional[Set[int]]:
        """CPU set for one worker under the big.LITTLE split: the top half
        of the allowed cores (at least one) serves big workers, the bottom
        half the little lanes; indices wrap. None = pinning unavailable or
        disabled (clean no-op)."""
        if not self.pin_cores or not _HAS_AFFINITY:
            return None
        try:
            cpus = sorted(os.sched_getaffinity(0))
        except OSError:
            return None
        if len(cpus) < 2:
            return None     # one core: pinning would only serialize lanes
        n_big_cpus = max(1, len(cpus) // 2)
        big_cpus = cpus[len(cpus) - n_big_cpus:]
        little_cpus = cpus[:len(cpus) - n_big_cpus]
        if wkind == "big":
            return {big_cpus[widx % len(big_cpus)]}
        return {little_cpus[widx % len(little_cpus)]}

    def _apply_pin(self, wkind: str, widx: int) -> None:
        """Called by each worker thread on entry (original and watchdog
        replacements alike); records the outcome in ``self.pinned``."""
        cpus = self._cpuset_for(wkind, widx)
        ok = _pin_current_thread(cpus) if cpus is not None else False
        with self._lock:
            self.pinned[threading.current_thread().name] = (
                sorted(cpus) if ok and cpus is not None else None)

    def _big_loop(self, i: int):
        self._apply_pin("big", i)
        self._worker_loop("big" if i == 0 else f"big{i}",
                          self._next_for_big, "big", i)

    def _little_loop(self, j: int):
        self._apply_pin("little", j)
        self._worker_loop(f"little{j}",
                          lambda now: self._next_for_little(j, now),
                          "little", j)

    def cancel_tasks(self, job: Job, tids: List[int], *,
                     reason: str = "race_lost") -> int:
        """Cancel the given tasks of ``job`` that have not started running.

        The warm-state race's loser-retirement path: when a ``fetch_remote``
        task lands a layer's staged weights first, the local
        read→transform→stage chain is cancelled through here (and when the
        local chain wins, the pending fetch task is).  Accounting mirrors
        ``_fail_job_locked`` — a cancelled task counts done, a cancelled
        prep decrements ``_prep_left`` (so preps-done still fires EXACTLY
        once and the admission slot is released), and each cancelled task's
        children are unblocked (``_mark_ready`` only fires for children
        still ``_PENDING``, so a cancelled sibling is never resurrected) —
        but the job stays healthy: no error, no cancellation of anything
        outside ``tids``.

        Tasks already ``_RUNNING`` are left alone — their normal completion
        path owns the accounting, and task fns are value-idempotent so
        letting a lost racer drain is harmless.  Returns the number
        actually cancelled."""
        fire_preps = False
        finished = False
        cancelled: List[int] = []
        with self._cv:
            for tid in tids:
                if job._state[tid] not in (_PENDING, _READY):
                    continue
                t = job.graph.tasks[tid]
                if job._state[tid] == _READY:
                    if tid in job._ready_big:
                        job._ready_big.remove(tid)
                    elif tid in job._ready_any:
                        job._ready_any.remove(tid)
                    else:
                        for rl in job._ready_little.values():
                            if tid in rl:
                                rl.remove(tid)
                                break
                job._state[tid] = _CANCELLED
                job._done_count += 1
                if t.kind in PREP_KINDS:
                    job._prep_left -= 1
                cancelled.append(tid)
            if cancelled:
                self.health["tasks_cancelled"] += len(cancelled)
                job.fault_events.append({
                    "action": "cancel", "reason": reason,
                    "tasks": [f"{job.graph.tasks[i].layer}/"
                              f"{job.graph.tasks[i].kind}"
                              for i in cancelled]})
                for tid in cancelled:
                    for child in job._children[tid]:
                        job._pending[child] -= 1
                        if job._pending[child] == 0 \
                                and job._state[child] == _PENDING:
                            job._mark_ready(child)
                if job._prep_left == 0 and not job._preps_fired:
                    job._preps_fired = True
                    fire_preps = True
                finished = job._finished()
                if finished and job in self._jobs:
                    self._jobs.remove(job)
                    self.jobs_completed += 1
                    job.total_s = time.perf_counter() - job.t0
                self._cv.notify_all()
        if fire_preps:
            job._fire_preps_callbacks()
        if finished:
            job._fire_done()
        return len(cancelled)

    def _fail_job_locked(self, job: Job, tid: int,
                         err: BaseException) -> Tuple[bool, bool]:
        """Under the pool lock: record ``err``, cancel the job's remaining
        tasks, and account task ``tid`` as done. Returns
        ``(fire_preps, finished)`` for the caller to act on OUTSIDE the
        lock."""
        task = job.graph.tasks[tid]
        if job.error is None:    # a job expired by the watchdog keeps its
            job.error = err      # typed DeadlineExceeded as THE error
            self.health["jobs_failed"] += 1
        job.fault_events.append({
            "layer": task.layer, "kind": task.kind, "action": "fail",
            "error": type(err).__name__})
        fire_preps = False
        for t2 in job.graph.tasks:
            if job._state[t2.tid] in (_PENDING, _READY):
                job._state[t2.tid] = _CANCELLED
                job._done_count += 1
        job._ready_big.clear()
        job._ready_any.clear()
        job._ready_little.clear()
        # a failed job must still release its admission slot:
        # cancelled preps will never complete, so fire preps-done now
        if not job._preps_fired:
            job._preps_fired = True
            fire_preps = True
        job._state[tid] = _DONE
        job._done_count += 1
        if task.kind in PREP_KINDS:
            job._prep_left -= 1
        finished = job._finished()
        if finished:
            self._jobs.remove(job)
            self.jobs_completed += 1
            job.total_s = time.perf_counter() - job.t0
        return fire_preps, finished

    def _run(self, job: Job, tid: int, core: str, wkind: str, widx: int):
        task = job.graph.tasks[tid]
        err: Optional[BaseException] = None
        with self._cv:
            epoch = job._epoch[tid]
            deadline = (task.deadline_s if task.deadline_s is not None
                        else job.deadline_s)
            self._running[(id(job), tid)] = {
                "job": job, "tid": tid, "epoch": epoch,
                "t0": time.perf_counter(), "deadline": deadline,
                "thread": threading.current_thread(),
                "wkind": wkind, "widx": widx}
        ts = time.perf_counter()
        try:
            inj = self.fault_injector
            if inj is not None:
                inj.maybe_fault(f"task.{task.kind}",
                                f"{job.name}:{task.layer}")
            task.fn()
        except BaseException as e:      # noqa: BLE001 — forwarded to caller
            err = classify(e, site=f"task.{task.kind}", layer=task.layer)
        te = time.perf_counter()
        fire_preps = False
        finished = False
        with self._cv:
            self._running.pop((id(job), tid), None)
            if job._epoch[tid] != epoch or job._state[tid] != _RUNNING:
                # the watchdog expired this attempt while it ran: the retry
                # owns the completion accounting now — discard ours (task
                # fns are value-idempotent, so a zombie that got this far
                # did no harm)
                self._cv.notify_all()
                return
            if (err is not None and isinstance(err, TransientFault)
                    and not self._shutdown and job.error is None
                    and job._attempts[tid] + 1 < job.retry.max_attempts):
                # bounded in-place retry with backoff: the task goes back to
                # its ready queue, eligible only after the backoff expires
                job._attempts[tid] += 1
                job.retries += 1
                self.health["task_retries"] += 1
                job._not_before[tid] = (
                    time.perf_counter()
                    + job.retry.delay(job._attempts[tid]))
                job.fault_events.append({
                    "layer": task.layer, "kind": task.kind,
                    "action": "retry", "attempt": job._attempts[tid],
                    "error": type(err).__name__})
                job._mark_ready(tid)
                self._cv.notify_all()
                return
            if err is not None:
                fire_preps, finished = self._fail_job_locked(job, tid, err)
            else:
                job.traces.append(OpTrace(task.layer, task.kind, core,
                                          ts - job.t0, te - job.t0))
                job._state[tid] = _DONE
                job._done_count += 1
                if task.kind in PREP_KINDS:
                    job._prep_left -= 1
                    if job._prep_left == 0 and not job._preps_fired:
                        job._preps_fired = True
                        fire_preps = True
                for child in job._children[tid]:
                    job._pending[child] -= 1
                    if job._pending[child] == 0 \
                            and job._state[child] == _PENDING:
                        job._mark_ready(child)
                finished = job._finished()
                if finished:
                    self._jobs.remove(job)
                    self.jobs_completed += 1
                    job.total_s = te - job.t0
            self._cv.notify_all()
        # callbacks and the done event fire outside the pool lock so they
        # may submit follow-up work without deadlocking
        if fire_preps:
            job._fire_preps_callbacks()
        if finished:
            job._fire_done()

    # -- watchdog ------------------------------------------------------------
    def _watchdog_loop(self):
        while True:
            actions: List[Tuple[Job, bool, bool]] = []
            with self._cv:
                self._cv.wait(timeout=self.watchdog_interval_s)
                if self._shutdown:
                    return
                now = time.perf_counter()
                for key in list(self._running):
                    rec = self._running.get(key)
                    if (rec is None or rec["deadline"] is None
                            or now - rec["t0"] <= rec["deadline"]):
                        continue
                    self._expire_locked(rec, now, actions)
                # end-to-end job deadlines: a job past its total budget
                # fails typed NOW — the client gets its fast answer and
                # (one tier up) the front door can shed or fail over
                for job in list(self._jobs):
                    if (job.job_deadline_s is not None
                            and job.error is None
                            and now - job.t0 > job.job_deadline_s):
                        self._expire_job_locked(job, actions)
                if actions:
                    self._cv.notify_all()
            for job, fire_preps, finished in actions:
                if fire_preps:
                    job._fire_preps_callbacks()
                if finished:
                    job._fire_done()

    def _expire_locked(self, rec: dict, now: float,
                       actions: List[Tuple[Job, bool, bool]]):
        """Under the pool lock: expire one overdue running task. Quarantines
        the stuck worker (retire + like-for-like replacement so the lane
        keeps draining), reschedules the lane's unstarted chains onto
        healthy lanes, and retries the expired prep task there — or fails
        the job for an overdue execute task / exhausted retry budget."""
        job, tid = rec["job"], rec["tid"]
        self._running.pop((id(job), tid), None)
        if job._epoch[tid] != rec["epoch"] or job._state[tid] != _RUNNING:
            return  # that attempt already resolved itself
        task = job.graph.tasks[tid]
        self.health["deadline_expired"] += 1
        # any completion the stuck thread eventually reports is a zombie now
        job._epoch[tid] += 1
        th = rec["thread"]
        if th is not None and th.is_alive() and th not in self._retired:
            self._retired.add(th)
            self._zombies.append(th)
            self.health["workers_replaced"] += 1
            widx, wkind = rec["widx"], rec["wkind"]
            if wkind == "little":
                self.health["lanes_quarantined"] += 1
                nth = threading.Thread(
                    target=self._little_loop, args=(widx,), daemon=True,
                    name=f"{self.name}-little{widx}r")
                self._little[widx] = nth
            else:
                nth = threading.Thread(
                    target=self._big_loop, args=(widx,), daemon=True,
                    name=f"{self.name}-big{widx}r")
                self._big[widx] = nth
            self.threads_created += 1
            nth.start()
            if wkind == "little":
                # reschedule the quarantined lane's unstarted chains onto
                # healthy lanes (inverted steal rule: emptiest lane wins)
                for j2 in self._jobs:
                    j2._requeue_from_lane(widx)
        if (task.kind in PREP_KINDS
                and job._attempts[tid] + 1 < job.retry.max_attempts):
            job._attempts[tid] += 1
            job.retries += 1
            self.health["task_retries"] += 1
            job.fault_events.append({
                "layer": task.layer, "kind": task.kind,
                "action": "deadline-retry", "attempt": job._attempts[tid],
                "error": "DeadlineExceeded"})
            if task.affinity == "little" and job.n_lanes > 1:
                # retarget the whole chain off the stuck lane; siblings are
                # still PENDING (they depend on this task), so updating
                # their lane tag is enough
                dest = (task.lane + 1) % job.n_lanes
                for tid2 in job._layer_chain.get(task.layer, []):
                    job.graph.tasks[tid2].lane = dest
                for lane, layers in job._lane_layers.items():
                    if task.layer in layers and lane != dest:
                        layers.remove(task.layer)
                        break
                if task.layer not in job._lane_layers.setdefault(dest, []):
                    job._lane_layers[dest].append(task.layer)
            job._not_before[tid] = now  # retry immediately, elsewhere
            job._mark_ready(tid)
        else:
            err = DeadlineExceeded(
                f"task {task.layer}/{task.kind} exceeded its "
                f"{rec['deadline']:.3f}s deadline", layer=task.layer)
            fire_preps, finished = self._fail_job_locked(job, tid, err)
            actions.append((job, fire_preps, finished))

    def _expire_job_locked(self, job: Job,
                           actions: List[Tuple[Job, bool, bool]]):
        """Under the pool lock: fail a job whose END-TO-END deadline
        (``job_deadline_s``, measured from ``t0``) is blown. Pending/ready
        tasks are cancelled; tasks already running finish on their own (task
        fns are value-idempotent, so letting them drain is harmless) and the
        job's done event fires once the last one returns."""
        job.error = DeadlineExceeded(
            f"job {job.name!r} exceeded its end-to-end "
            f"{job.job_deadline_s:.3f}s deadline")
        self.health["jobs_failed"] += 1
        self.health["job_deadline_expired"] += 1
        job.fault_events.append({
            "action": "job-deadline-fail", "error": "DeadlineExceeded",
            "deadline_s": job.job_deadline_s})
        for t2 in job.graph.tasks:
            if job._state[t2.tid] in (_PENDING, _READY):
                job._state[t2.tid] = _CANCELLED
                job._done_count += 1
        job._ready_big.clear()
        job._ready_any.clear()
        job._ready_little.clear()
        fire_preps = False
        # cancelled preps will never complete: release the admission slot
        if not job._preps_fired:
            job._preps_fired = True
            fire_preps = True
        finished = job._finished()
        if finished:
            self._jobs.remove(job)
            self.jobs_completed += 1
            job.total_s = time.perf_counter() - job.t0
        actions.append((job, fire_preps, finished))


# ---------------------------------------------------------------------------
# the process-wide pool
# ---------------------------------------------------------------------------
_GLOBAL: Optional[CorePool] = None
_GLOBAL_LOCK = threading.Lock()


def get_core_pool(n_little: int = 3, n_big: int = 2) -> CorePool:
    """The process-wide persistent pool, created on first use and grown on
    demand — every runtime and every model share it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = CorePool(n_big=n_big, n_little=n_little, name="global")
            return _GLOBAL
    return _GLOBAL.ensure(n_little=n_little, n_big=n_big)


def reset_core_pool() -> None:
    """Shut the global pool down (tests only — the whole point of the pool
    is that production never does this)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.shutdown()
            _GLOBAL = None
