"""FrontDoor — supervised multi-worker serving tier above ColdServer.

One front-door process owns N **worker processes**, each running a full
``ColdServer`` (own engines, own store root, own pool) behind a
length-prefixed pickle RPC channel on a localhost socket. The front door
adds the fault/latency tier the single-process server cannot provide:

  * **supervision** — every worker heartbeats its serializable
    ``health()`` snapshot; a missed-heartbeat budget (``HeartbeatPolicy``)
    or a dead pid marks the worker lost, and the supervisor restarts it
    under exponential backoff (``RestartPolicy``);
  * **crash failover** — requests in flight on a lost worker are failed
    over to a sibling at the head of their lane queue. Cold starts are
    idempotent by construction (same seeded weights, plans resolved from
    one shared ``ProfileDB``), so the replayed output is bit-identical to
    an isolated run; only when every sibling is gone does the client see
    a typed ``WorkerLost``;
  * **deadline propagation** — a request's end-to-end budget is decayed
    by its queue wait and an RPC-overhead allowance before it reaches the
    worker, where it becomes the pool watchdog's per-job deadline
    (typed ``DeadlineExceeded`` once blown);
  * **priority lanes + load shedding** — two admission lanes: interactive
    requests always dispatch first and ``interactive_reserve`` worker
    slots are never given to batch work, so an interactive arrival waits
    at most ~one service time behind the reserve. Requests that cannot
    make their deadline (budget below the RPC floor, or the lane's
    estimated queue delay exceeds the remaining budget) and requests for
    quarantined models are shed with typed faults *before* consuming a
    worker slot;
  * **cost-based cache-aware routing** — heartbeat health snapshots carry
    each worker's resident (device-warm) and previously-served
    (page-cache warm) model sets, per-model resident byte counts, and its
    measured peer-link bandwidth; routing scores every capable worker by
    estimated time-to-result, where a non-resident worker's cold cost is
    ``min(local cold estimate, peer transfer_estimate)`` — so the front
    door can deliberately send a request to a *cold* worker when pulling
    the warm state from a sibling's RAM beats that worker's disk. The
    dispatched ``cold_start`` carries the matching ``peers`` list and the
    worker races the transfer against its local prep chains
    (``docs/warm_transfer.md``).

Protocol (length-prefixed pickled dicts; workers connect back to the
front door's listener): ``hello`` → (``add_model`` → ``model_ready``)*,
then ``cold_start`` → ``result``/``error`` interleaved with
``heartbeat``, and ``drain``/``drained`` + ``shutdown`` at the end.

The port of ``repro/executor/frontdoor.py``: the same framing (byte for
byte), fault transport, lanes, shedding, routing and supervision. Each
worker is a fresh interpreter, ``python -m repro_torch.executor.worker``
started with ``subprocess`` (never ``multiprocessing``'s ``fork``, which
would copy a CUDA context), and serves on the front door's ``device``
(default ``"cuda"``, which raises without a card). On a card the front door builds every kernel
library once before it spawns a worker, so the workers load the built
libraries instead of each starting the same ``nvcc`` builds at once.
Results carry the output as a host array, the worker's pid and its
process's kernel launch counts.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

import repro_torch
from repro_torch import faults as _faults
from repro_torch.core.scheduler import transfer_estimate
from repro_torch.device import resolve_device
from repro_torch.faults import (
    DeadlineExceeded, Fault, HeartbeatPolicy, JobTimeout, ModelQuarantined,
    RepairLog, RestartPolicy, WorkerLost,
)

# -- wire format -------------------------------------------------------------
# 4-byte big-endian length + pickled dict. Localhost-only, both ends are this
# codebase — pickle is the zero-dependency way to move numpy arrays intact.

_LEN = struct.Struct(">I")


def send_msg(sock: socket.socket, obj: Dict[str, Any],
             lock: Optional[threading.Lock] = None) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _LEN.pack(len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """One framed message; None on clean EOF (peer gone)."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return pickle.loads(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """``n`` bytes into one buffer (a warm-state chunk is megabytes: no
    copy per received piece); None on EOF or a socket error."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if not k:
            return None
        got += k
    return buf


def rebuild_fault(err: Dict[str, Any]) -> BaseException:
    """Typed fault from a worker's ``describe()``-shaped error dict — the
    taxonomy crosses the process boundary instead of degrading to
    RuntimeError."""
    cls = getattr(_faults, str(err.get("type", "")), None)
    if isinstance(cls, type) and issubclass(cls, Fault):
        return cls(str(err.get("msg", "")),
                   layer=err.get("layer"), kernel=err.get("kernel"),
                   site=err.get("site"), retry_after=err.get("retry_after"))
    return RuntimeError(str(err.get("msg", "")) or repr(err))


# -- request + worker handles ------------------------------------------------

INTERACTIVE = "interactive"
BATCH = "batch"


class FrontDoorRequest:
    """Client-side handle for one front-door request."""

    def __init__(self, rid: int, model: str, x, lane: str,
                 deadline_s: Optional[float],
                 pinned: Optional[str] = None):
        self.rid = rid
        self.model = model
        self.x = x
        self.lane = lane
        self.deadline_s = deadline_s           # end-to-end budget
        self.pinned = pinned                   # routing pin (benchmarks/ops)
        self.t0 = time.monotonic()
        self.attempts = 0                      # dispatch attempts (failovers)
        self.worker: Optional[str] = None
        self._done = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None

    # budget left right now (None = unbounded)
    def remaining_s(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.monotonic() - self.t0)

    def _complete(self, result=None, error=None):
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._done.wait(timeout):
            raise JobTimeout(
                f"front-door request {self.rid} ({self.model!r}) still "
                f"pending after {timeout}s wait")
        if self._error is not None:
            raise self._error
        return self._result


class _Worker:
    """Supervisor-side state for one worker process."""

    def __init__(self, wid: str):
        self.wid = wid
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.alive = False
        self.last_heartbeat = 0.0
        self.health: Dict[str, Any] = {}
        self.in_flight: Dict[int, FrontDoorRequest] = {}
        self.warm_port: Optional[int] = None   # warm-state transfer port
        self.restarts = 0                      # completed restarts
        self.down_at: Optional[float] = None   # when it was declared lost
        self.restart_due: Optional[float] = None
        self.last_restart_delay = 0.0
        self.ready_models: set = set()
        self.model_ready_evt: Dict[str, threading.Event] = {}
        self.hello_evt = threading.Event()

    def capacity(self, max_inflight: int) -> int:
        return max(0, max_inflight - len(self.in_flight)) if self.alive else 0


class FrontDoor:
    """Supervised multi-worker front door (see module docstring)."""

    def __init__(
        self,
        root,
        *,
        n_workers: int = 2,
        max_inflight_per_worker: int = 2,
        interactive_reserve: int = 1,
        heartbeat: HeartbeatPolicy = HeartbeatPolicy(),
        restart: RestartPolicy = RestartPolicy(base_s=0.1, max_s=5.0),
        max_failovers: int = 2,
        rpc_overhead_s: float = 0.050,
        spawn_timeout_s: float = 120.0,
        worker_args: Optional[Dict[str, Any]] = None,
        device: Any = "cuda",
    ):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.n_workers = n_workers
        self.max_inflight = max_inflight_per_worker
        self.interactive_reserve = min(interactive_reserve,
                                       n_workers * max_inflight_per_worker)
        self.heartbeat = heartbeat
        self.restart = restart
        self.max_failovers = max_failovers
        self.rpc_overhead_s = rpc_overhead_s
        self.spawn_timeout_s = spawn_timeout_s
        self.worker_args = dict(worker_args or {})
        # one profile DB file shared by every worker: worker 0 measures
        # during model registration, siblings reload and hit — identical
        # plans, hence bit-identical outputs across workers (the failover
        # correctness invariant)
        self.profile_db_path = self.root / "profile_db.json"
        self.repairs = RepairLog(self.root / "frontdoor_repairs.jsonl")

        self._lock = threading.Lock()
        self._dispatch_cv = threading.Condition(self._lock)
        self._workers: "OrderedDict[str, _Worker]" = OrderedDict(
            (f"w{i}", _Worker(f"w{i}")) for i in range(n_workers))
        self._models: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._queues: Dict[str, Deque[FrontDoorRequest]] = {
            INTERACTIVE: deque(), BATCH: deque()}
        self._rid = 0
        self._quarantine: Dict[str, float] = {}   # model -> retry-at (mono)
        self._svc_ewma: Dict[str, float] = {}     # model -> service time est
        self._batch_in_flight = 0
        self._shutdown = False
        self.stats = {
            "requests": 0, "completed": 0, "failed": 0,
            "shed_deadline": 0, "shed_quarantine": 0,
            "failovers": 0, "failover_lost": 0,
            "worker_restarts": 0, "workers_lost": 0,
            "dispatched_interactive": 0, "dispatched_batch": 0,
            "warm_results": 0,
        }
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
        if self.device.type == "cuda":
            # one parallel build here, before any worker exists: the
            # workers then only load the libraries (a build directory
            # has no lock across processes)
            from repro_torch.kernels import _native

            _native.build_all()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.n_workers * 2)
        self._port = self._listener.getsockname()[1]
        self._spawn_thread("fd-accept", self._accept_loop)
        for w in self._workers.values():
            self._spawn_worker(w)
        for w in self._workers.values():
            if not w.hello_evt.wait(self.spawn_timeout_s):
                raise RuntimeError(f"worker {w.wid} never said hello")
        self._spawn_thread("fd-dispatch", self._dispatch_loop)
        self._spawn_thread("fd-supervisor", self._supervise_loop)
        return self

    def _spawn_thread(self, name, target):
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _spawn_worker(self, w: _Worker) -> None:
        wroot = self.root / w.wid
        wroot.mkdir(parents=True, exist_ok=True)
        # __path__[0] is .../src/repro_torch
        src = str(Path(list(repro_torch.__path__)[0]).resolve().parent)
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        argv = [sys.executable, "-m", "repro_torch.executor.worker",
                "--host", "127.0.0.1", "--port", str(self._port),
                "--worker-id", w.wid, "--root", str(wroot),
                "--profile-db", str(self.profile_db_path),
                "--heartbeat-interval", str(self.heartbeat.interval_s),
                "--device", str(self.device)]
        for k, v in self.worker_args.items():
            argv += [f"--{k.replace('_', '-')}", str(v)]
        w.hello_evt.clear()
        # a (re)spawned worker serves a model only once it has confirmed
        # the model's registration again
        w.ready_models = set()
        w.proc = subprocess.Popen(argv, env=env,
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)

    def _accept_loop(self):
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed — shutting down
            try:
                hello = recv_msg(sock)
            except Exception:
                sock.close()
                continue
            if not hello or hello.get("type") != "hello":
                sock.close()
                continue
            wid = hello.get("worker")
            w = self._workers.get(wid)
            if w is None:
                sock.close()
                continue
            with self._lock:
                w.sock = sock
                w.alive = True
                w.last_heartbeat = time.monotonic()
                w.warm_port = hello.get("warm_port")
                w.down_at = None
                w.restart_due = None
            threading.Thread(target=self._recv_loop, args=(w, sock),
                             name=f"fd-recv-{wid}", daemon=True).start()
            w.hello_evt.set()
            with self._dispatch_cv:
                self._dispatch_cv.notify_all()

    # -- model registration --------------------------------------------------
    def add_model(self, name: str, builder: str, /, **kwargs) -> None:
        """Register a model on every worker. ``builder`` is
        ``"module:function"``; calling it with ``kwargs`` must return
        ``(layers, x_example)`` deterministically (seeded) — determinism is
        what makes crash failover bit-identical.

        Registration is **sequential**: the first worker profiles and saves
        into the shared profile DB; each subsequent worker reloads the DB,
        hits every shape class, and lands on the same plan."""
        spec = {"name": name, "builder": builder, "kwargs": kwargs}
        self._models[name] = spec
        for w in self._workers.values():
            self._register_on(w, spec, timeout=self.spawn_timeout_s)

    def _register_on(self, w: _Worker, spec: Dict[str, Any],
                     timeout: float) -> None:
        name = spec["name"]
        evt = threading.Event()
        w.model_ready_evt[name] = evt
        send_msg(w.sock, {"type": "add_model", **spec}, w.send_lock)
        if not evt.wait(timeout):
            raise RuntimeError(
                f"worker {w.wid} did not confirm model {name!r}")

    # -- client API ----------------------------------------------------------
    def request(self, model: str, x, *, deadline_s: Optional[float] = None,
                lane: str = INTERACTIVE,
                worker: Optional[str] = None) -> FrontDoorRequest:
        """Enqueue one request. Sheds with a typed fault — *before* the
        request ever holds a worker slot — when the model is in quarantine
        or the budget cannot survive the queue + RPC floor.
        ``worker`` pins routing to one worker id (benchmark/operator lever
        — e.g. forcing a second worker's cold start to measure the peer
        warm-state transfer); the pin falls back to normal routing if that
        worker is down."""
        if lane not in (INTERACTIVE, BATCH):
            raise ValueError(f"unknown lane {lane!r}")
        if model not in self._models:
            raise KeyError(f"model {model!r} not registered")
        now = time.monotonic()
        with self._lock:
            if self._shutdown:
                raise RuntimeError("front door is shut down")
            until = self._quarantine.get(model)
            if until is not None and now < until:
                self.stats["shed_quarantine"] += 1
                raise ModelQuarantined(
                    f"model {model!r} quarantined fleet-wide; retry in "
                    f"{until - now:.2f}s", retry_after=until - now)
            if deadline_s is not None:
                if deadline_s <= self.rpc_overhead_s:
                    self.stats["shed_deadline"] += 1
                    raise DeadlineExceeded(
                        f"budget {deadline_s:.3f}s below the "
                        f"{self.rpc_overhead_s:.3f}s RPC floor — shed "
                        f"before queuing")
                est = self._queue_delay_est_locked(model, lane)
                if est is not None and est > deadline_s - self.rpc_overhead_s:
                    self.stats["shed_deadline"] += 1
                    raise DeadlineExceeded(
                        f"estimated {lane} queue delay {est:.3f}s exceeds "
                        f"remaining budget {deadline_s:.3f}s — shed before "
                        f"queuing")
            self._rid += 1
            req = FrontDoorRequest(self._rid, model, x, lane, deadline_s,
                                   pinned=worker)
            self.stats["requests"] += 1
            self._queues[lane].append(req)
            self._dispatch_cv.notify_all()
        return req

    def _queue_delay_est_locked(self, model: str,
                                lane: str) -> Optional[float]:
        """Conservative wait estimate: jobs ahead in this lane (plus every
        interactive job, which preempts batch) over live dispatch slots,
        times the model's EWMA service time. None until a completion has
        seeded the EWMA — never shed on zero knowledge."""
        svc = self._svc_ewma.get(model)
        if svc is None:
            return None
        ahead = len(self._queues[lane])
        if lane == BATCH:
            ahead += len(self._queues[INTERACTIVE])
        slots = sum(w.capacity(self.max_inflight)
                    for w in self._workers.values())
        slots = max(1, slots)
        return (ahead // slots) * svc

    # -- dispatcher ----------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            with self._dispatch_cv:
                while not self._shutdown and not self._dispatchable_locked():
                    self._dispatch_cv.wait(0.05)
                if self._shutdown:
                    return
                picks = []
                while True:
                    pick = self._pick_locked()
                    if pick is None:
                        break
                    req, w = pick
                    req.worker = w.wid
                    req.attempts += 1
                    w.in_flight[req.rid] = req
                    if req.lane == BATCH:
                        self._batch_in_flight += 1
                        self.stats["dispatched_batch"] += 1
                    else:
                        self.stats["dispatched_interactive"] += 1
                    picks.append((req, w))
            for req, w in picks:
                self._send_request(req, w)

    def _dispatchable_locked(self) -> bool:
        return bool(self._queues[INTERACTIVE] or self._queues[BATCH])

    def _pick_locked(self):
        """Next (request, worker): interactive lane strictly first; batch
        only while it leaves ``interactive_reserve`` slots free. Routing
        prefers device-resident, then previously-served (cache-warm), then
        least-loaded."""
        total = sum(w.capacity(self.max_inflight)
                    for w in self._workers.values())
        if total <= 0:
            return None
        req = None
        if self._queues[INTERACTIVE]:
            req = self._queues[INTERACTIVE].popleft()
        elif self._queues[BATCH] and total > self.interactive_reserve:
            # the reserve is measured in FREE slots: batch may take this
            # slot only if at least interactive_reserve+1 are free now
            req = self._queues[BATCH].popleft()
        if req is None:
            return None
        w = self._route_locked(req.model, pinned=req.pinned)
        if w is None:                   # lost the race for the last slot
            self._queues[req.lane].appendleft(req)
            return None
        return req, w

    def _transfer_donors_locked(self, model: str
                                ) -> List[Tuple[str, int, float]]:
        """Alive workers holding ``model`` device-resident with a reachable
        warm-state port: ``(wid, resident_bytes, link_bytes_per_s)`` —
        both the routing cost model and the dispatched request's ``peers``
        list come from here, so what routing assumed is what the worker
        actually races against."""
        donors = []
        for w in self._workers.values():
            if not w.alive or w.warm_port is None:
                continue
            h = w.health or {}
            if model not in (h.get("resident") or ()):
                continue
            nbytes = int((h.get("resident_model_bytes") or {})
                         .get(model) or 0)
            if nbytes <= 0:
                nbytes = int(h.get("resident_bytes") or 0)
            donors.append((w.wid, nbytes,
                           float(h.get("link_bytes_per_s") or 0.0)))
        return donors

    def _route_locked(self, model: str, *,
                      pinned: Optional[str] = None) -> Optional[_Worker]:
        """Cost-based routing: pick the worker with the lowest estimated
        time-to-result, where a NON-resident worker's cold cost is
        ``min(local cold estimate, peer transfer estimate)`` — the same
        ``transfer_estimate`` arithmetic the worker's own race-arming
        decision uses (``ColdServer._maybe_peer_fetch``), so the front
        door can deliberately route to a cold worker when a sibling's RAM
        beats that worker's disk:

          resident        → svc                      (warm run)
          served before   → svc + min(svc,  transfer)  (page cache warm)
          never served    → svc + min(3·svc, transfer)  (cold disk)
          queue delay     → + in_flight × svc

        Only workers that have confirmed the model's registration are
        candidates: a restarted worker is alive from its hello on, before
        its models are registered again.

        Cost ties (in particular before any completion seeds the model's
        service-time EWMA, when every estimate is 0) break by warmth tier
        (resident > served > cold) and then least-loaded — never a shed,
        never a stall, exactly the pre-cost-model policy."""
        if pinned is not None:
            w = self._workers.get(pinned)
            ready = w is not None and model in w.ready_models
            if ready and w.capacity(self.max_inflight) > 0:
                return w
            if ready and w.alive:
                return None     # pinned worker is full: wait for its slot
            # pinned worker is down or not (yet) serving the model — fall
            # through to normal routing
        svc = self._svc_ewma.get(model) or 0.0
        donors = self._transfer_donors_locked(model)
        best, best_key = None, None
        for w in self._workers.values():
            if w.capacity(self.max_inflight) <= 0 \
                    or model not in w.ready_models:
                continue
            h = w.health or {}
            resident = model in (h.get("resident") or ())
            served = (h.get("served") or {}).get(model, 0) > 0
            if resident:
                prep = 0.0
            else:
                local = svc * (1.0 if served else 3.0)
                transfer = min(
                    (transfer_estimate(nb, bw)
                     for wid, nb, bw in donors if wid != w.wid),
                    default=float("inf"))
                prep = min(local, transfer) if donors else local
            cost = prep + svc + len(w.in_flight) * svc
            tier = 0 if resident else (1 if served else 2)
            key = (cost, tier, len(w.in_flight))
            if best_key is None or key < best_key:
                best, best_key = w, key
        return best

    def _send_request(self, req: FrontDoorRequest, w: _Worker):
        remaining = req.remaining_s()
        if remaining is not None:
            remaining -= self.rpc_overhead_s
            if remaining <= 0:
                self._finish(req, w, error=DeadlineExceeded(
                    f"request {req.rid} ({req.model!r}) spent its budget "
                    f"queued at the front door"))
                with self._lock:
                    self.stats["shed_deadline"] += 1
                return
        # sibling workers holding this model resident: the worker arms a
        # warm-state fetch race against them iff the same transfer estimate
        # routing just used says the peer beats its local disk
        with self._lock:
            peers = [{"host": "127.0.0.1", "port": self._workers[wid].warm_port,
                      "resident_bytes": nb, "link_bytes_per_s": bw}
                     for wid, nb, bw in
                     self._transfer_donors_locked(req.model)
                     if wid != w.wid]
        try:
            send_msg(w.sock, {"type": "cold_start", "rid": req.rid,
                              "model": req.model, "x": req.x,
                              "deadline_s": remaining, "lane": req.lane,
                              "peers": peers},
                     w.send_lock)
        except OSError:
            # socket died under us; the supervisor will fail this over
            pass

    # -- worker receive path -------------------------------------------------
    def _recv_loop(self, w: _Worker, sock: socket.socket):
        while True:
            try:
                msg = recv_msg(sock)
            except Exception:
                msg = None
            if msg is None:
                return  # EOF: supervisor declares the loss
            t = msg.get("type")
            if t == "heartbeat":
                with self._lock:
                    w.last_heartbeat = time.monotonic()
                    w.health = msg.get("health") or {}
            elif t == "model_ready":
                w.ready_models.add(msg.get("name"))
                evt = w.model_ready_evt.get(msg.get("name"))
                if evt is not None:
                    evt.set()
            elif t == "result":
                req = w.in_flight.get(msg.get("rid"))
                if req is not None:
                    with self._lock:
                        svc = float(msg.get("total_s") or 0.0)
                        prev = self._svc_ewma.get(req.model)
                        self._svc_ewma[req.model] = (
                            svc if prev is None else 0.7 * prev + 0.3 * svc)
                        self._quarantine.pop(req.model, None)
                        if msg.get("warm"):
                            self.stats["warm_results"] += 1
                    self._finish(req, w, result=msg)
            elif t == "error":
                req = w.in_flight.get(msg.get("rid"))
                if req is not None:
                    fault = rebuild_fault(msg.get("fault") or {})
                    if isinstance(fault, ModelQuarantined) \
                            and fault.retry_after:
                        with self._lock:
                            self._quarantine[req.model] = (
                                time.monotonic() + fault.retry_after)
                    self._finish(req, w, error=fault)

    def _finish(self, req: FrontDoorRequest, w: Optional[_Worker], *,
                result=None, error=None):
        with self._lock:
            if w is not None:
                w.in_flight.pop(req.rid, None)
            if req.lane == BATCH and req.worker is not None:
                self._batch_in_flight = max(0, self._batch_in_flight - 1)
            self.stats["completed" if error is None else "failed"] += 1
            self._dispatch_cv.notify_all()
        req._complete(result=result, error=error)

    # -- supervisor ----------------------------------------------------------
    def _supervise_loop(self):
        while not self._shutdown:
            time.sleep(self.heartbeat.interval_s / 2)
            now = time.monotonic()
            lost: List[_Worker] = []
            due: List[_Worker] = []
            with self._lock:
                for w in self._workers.values():
                    if w.alive:
                        dead_pid = (w.proc is not None
                                    and w.proc.poll() is not None)
                        stale = (now - w.last_heartbeat
                                 > self.heartbeat.timeout_s)
                        if dead_pid or stale:
                            w.alive = False
                            w.down_at = now
                            w.restarts += 1
                            delay = self.restart.delay(w.restarts)
                            w.last_restart_delay = delay
                            exhausted = (
                                self.restart.max_restarts is not None
                                and w.restarts > self.restart.max_restarts)
                            w.restart_due = None if exhausted else now + delay
                            self.stats["workers_lost"] += 1
                            lost.append(w)
                    elif w.restart_due is not None and now >= w.restart_due:
                        w.restart_due = None
                        due.append(w)
            for w in lost:
                self._on_worker_lost(w)
            for w in due:
                self._restart_worker(w)

    def _on_worker_lost(self, w: _Worker):
        """Close the channel, then fail the lost worker's in-flight requests
        over to siblings (head of their lane queue) — or fail them typed
        ``WorkerLost`` once ``max_failovers`` replays are spent."""
        self.repairs.record("worker_lost", worker=w.wid,
                            restarts=w.restarts,
                            in_flight=len(w.in_flight),
                            backoff_s=w.last_restart_delay)
        if w.sock is not None:
            try:
                w.sock.close()
            except OSError:
                pass
            w.sock = None
        if w.proc is not None and w.proc.poll() is None:
            w.proc.kill()   # stopped heartbeating but pid alive: zombie
        orphans: List[FrontDoorRequest] = []
        with self._lock:
            orphans = list(w.in_flight.values())
            w.in_flight.clear()
        for req in orphans:
            if req.lane == BATCH:
                with self._lock:
                    self._batch_in_flight = max(0, self._batch_in_flight - 1)
            req.worker = None
            if req.attempts > self.max_failovers:
                with self._lock:
                    self.stats["failover_lost"] += 1
                    self.stats["failed"] += 1
                req._complete(error=WorkerLost(
                    f"request {req.rid} ({req.model!r}) lost worker "
                    f"{w.wid} after {req.attempts} attempts"))
                continue
            with self._lock:
                self.stats["failovers"] += 1
                # head of the lane: a failover has already waited once
                self._queues[req.lane].appendleft(req)
                self._dispatch_cv.notify_all()
            self.repairs.record("request_failover", rid=req.rid,
                                model=req.model, lane=req.lane,
                                from_worker=w.wid, attempt=req.attempts)

    def _restart_worker(self, w: _Worker):
        self.stats["worker_restarts"] += 1
        self.repairs.record("worker_restart", worker=w.wid,
                            restarts=w.restarts,
                            backoff_s=w.last_restart_delay)
        try:
            self._spawn_worker(w)
        except Exception:
            with self._lock:   # spawn itself failed: back off again
                w.restart_due = (time.monotonic()
                                 + self.restart.delay(w.restarts + 1))
            return
        if not w.hello_evt.wait(self.spawn_timeout_s):
            return  # supervisor will see the dead pid and re-backoff
        for spec in self._models.values():
            try:
                self._register_on(w, spec, timeout=self.spawn_timeout_s)
            except Exception:
                return

    # -- introspection / control --------------------------------------------
    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stats": dict(self.stats),
                "queues": {lane: len(q) for lane, q in self._queues.items()},
                "batch_in_flight": self._batch_in_flight,
                "workers": {
                    w.wid: {
                        "alive": w.alive,
                        "pid": (w.proc.pid if w.proc is not None else None),
                        "restarts": w.restarts,
                        "in_flight": len(w.in_flight),
                        "last_restart_delay": w.last_restart_delay,
                        "resident": list((w.health or {}).get(
                            "resident") or []),
                    } for w in self._workers.values()},
            }

    def worker_pid(self, wid: str) -> Optional[int]:
        w = self._workers[wid]
        return w.proc.pid if w.proc is not None else None

    def kill_worker(self, wid: str, sig: int = 9) -> None:
        """Chaos hook: signal a worker process (default SIGKILL)."""
        pid = self.worker_pid(wid)
        if pid is not None:
            os.kill(pid, sig)

    def shutdown(self, drain_timeout_s: float = 5.0) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._dispatch_cv.notify_all()
        for w in self._workers.values():
            if w.sock is not None and w.alive:
                try:
                    send_msg(w.sock, {"type": "drain",
                                      "timeout_s": drain_timeout_s},
                             w.send_lock)
                    send_msg(w.sock, {"type": "shutdown"}, w.send_lock)
                except OSError:
                    pass
        deadline = time.monotonic() + drain_timeout_s
        for w in self._workers.values():
            if w.proc is None:
                continue
            try:
                w.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
            if w.sock is not None:
                try:
                    w.sock.close()
                except OSError:
                    pass
        if self._listener is not None:
            self._listener.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
