"""Front-door worker entrypoint — one supervised ColdServer per process.

``python -m repro_torch.executor.worker --host H --port P --worker-id W
--device cuda ...`` connects back to the front door's listener, says
hello, and serves the RPC protocol from
:mod:`repro_torch.executor.frontdoor`: ``add_model`` builds
the model from its ``module:function`` builder spec and registers it
(reloading the shared profile DB first, so every worker resolves the
same plan the first worker measured), ``cold_start`` serves a request
(warm path first, then an admitted cold start under the propagated
deadline), and a background thread heartbeats the server's serializable
``health()`` snapshot. Faults cross back typed via ``describe()``.

Two serving refinements live here rather than in the ColdServer:

  * **warm-run coalescing** — same-model requests that queue up while a
    warm drain is running are batched into ONE ``warm_run_many`` sweep
    (one per-layer walk serves all of them) instead of N serial runs;
  * **peer warm-state transfer** — a ``WarmStateServer`` listens on its
    own port (reported in the hello and every heartbeat) serving this
    worker's resident staged weights to siblings, and the ``peers`` list
    the front door attaches to a ``cold_start`` is handed to
    ``ColdServer.cold_start``, which races a peer fetch against the
    local disk chains when the transfer estimate wins
    (``docs/warm_transfer.md``).

The process is designed to be killed: all state it owns (store, plan,
profile entries) is either re-derivable or persisted, and the front door
replays in-flight requests on a sibling.

The port of ``repro/executor/worker.py``. ``--device`` (default
``cuda``) is the ``ColdServer``'s device; on a card the worker makes its
CUDA context and loads the kernel libraries before it says hello, so
neither lands inside the first cold start or skews the warm-state race.
A result carries the output as a host array, the worker's pid, the
kernel launches of that request's own run (the change in the process's
counts across it; a coalesced warm batch's ride its first result) and,
when a peer fetch raced the disk, the race's closing journal line (layers
and bytes fetched) with the layers the peer won. A ``plan.json`` already
in the model's store is adopted (``ColdEngine.adopt_plan``) instead of
deciding: that is how a restart keeps its plan, and how one plan is
pinned across a fleet (write it into every worker's store before
``add_model``).
"""
from __future__ import annotations

import argparse
import importlib
import os
import socket
import sys
import threading
from pathlib import Path

from repro_torch.executor.frontdoor import recv_msg, send_msg
from repro_torch.faults import Fault


def _build(spec):
    mod_name, _, fn_name = spec["builder"].partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(**(spec.get("kwargs") or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--profile-db", default=None)
    ap.add_argument("--heartbeat-interval", type=float, default=0.2)
    ap.add_argument("--n-little", type=int, default=2)
    ap.add_argument("--n-big", type=int, default=1)
    ap.add_argument("--max-concurrent-preps", type=int, default=2)
    ap.add_argument("--pin-cores", action="store_true")
    ap.add_argument("--store-fmt", default=None,
                    help="layer-store format for registered models "
                         "(e.g. 'super' to get measured local-read-bytes "
                         "accounting; default: the engine's default)")
    ap.add_argument("--sim-disk-bytes-per-s", type=float, default=None,
                    help="emulate an edge flash device: pace local store "
                         "reads to this shared bandwidth (CI hosts serve "
                         "the store from page cache at memory speed; the "
                         "warm-transfer gate needs disk time to be real)")
    ap.add_argument("--device", default="cuda",
                    help="the ColdServer's device (raises without a card "
                         "unless 'cpu')")
    args = ap.parse_args(argv)

    # imports deferred past argparse so --help stays instant
    import torch

    from repro_torch.core.profiler import ProfileDB
    from repro_torch.device import resolve_device, to_numpy
    from repro_torch.executor.pool import CorePool
    from repro_torch.executor.server import ColdServer
    from repro_torch.executor.warmstate import WarmStateServer
    from repro_torch.kernels import ops

    if args.sim_disk_bytes_per_s:
        from repro_torch.ioengine import get_io_engine
        get_io_engine().set_sim_read_bandwidth(args.sim_disk_bytes_per_s)

    # make the CUDA context and load the kernel libraries now, not inside
    # the first request: both would otherwise land inside the first cold
    # start's submit path — dwarfing the job itself and skewing the
    # warm-state race (the peer stream would start late)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _native

        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        _native.load_all()

    pool = CorePool(n_little=args.n_little, n_big=args.n_big,
                    pin_cores=args.pin_cores)
    server = ColdServer(args.root, pool=pool, n_little=args.n_little,
                        max_concurrent_preps=args.max_concurrent_preps,
                        share_profile_db=args.profile_db is None,
                        device=device)
    # peer warm-state transfer endpoint: siblings cold-start this worker's
    # resident models straight out of our RAM (docs/warm_transfer.md)
    warm = WarmStateServer(server)
    sock = socket.create_connection((args.host, args.port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()
    send_msg(sock, {"type": "hello", "worker": args.worker_id,
                    "pid": os.getpid(), "warm_port": warm.port}, send_lock)

    examples = {}          # model -> x_example (for restart-side decide)
    stop = threading.Event()

    def heartbeat():
        while not stop.wait(args.heartbeat_interval):
            try:
                health = server.health()
                health["warm_port"] = warm.port
                health["warmstate"] = dict(warm.stats)
                send_msg(sock, {"type": "heartbeat",
                                "worker": args.worker_id,
                                "health": health}, send_lock)
            except OSError:
                return  # front door gone: exit quietly

    threading.Thread(target=heartbeat, name="worker-heartbeat",
                     daemon=True).start()

    def handle_add_model(msg):
        name = msg["name"]
        try:
            if args.profile_db is not None:
                # reload the SHARED db so measurements a sibling saved
                # since our startup are visible — this is what makes every
                # worker resolve the same plan (bit-identical failover)
                server.profile_db = ProfileDB(Path(args.profile_db))
            layers, x = _build(msg)
            examples[name] = x
            if name not in server.engines:
                engine_kw = ({"store_fmt": args.store_fmt}
                             if args.store_fmt else {})
                server.add_model(name, layers, **engine_kw)
            plan_path = server.root / name / "plan.json"
            if plan_path.exists():   # restart or pinned: reuse the plan
                server.engines[name].adopt_plan(x, n_little=args.n_little)
            else:
                server.decide(name, x)
            send_msg(sock, {"type": "model_ready", "name": name}, send_lock)
        except Exception as e:
            send_msg(sock, {"type": "error", "rid": None, "name": name,
                            "fault": _fault_dict(e)}, send_lock)

    def _launched_since(before):
        return {k: n - before.get(k, 0)
                for k, n in ops.launch_counts().items()}

    def _send_result(msg, res, *, warm, launches, batched=1, peer=None):
        send_msg(sock, {"type": "result", "rid": msg["rid"],
                        "worker": args.worker_id, "warm": warm,
                        "batched": batched, "peer": peer,
                        "output": to_numpy(res.output),
                        "total_s": res.total_s, "pid": os.getpid(),
                        "launches": launches}, send_lock)

    def _send_error(msg, e):
        try:
            send_msg(sock, {"type": "error", "rid": msg["rid"],
                            "fault": _fault_dict(e)}, send_lock)
        except OSError:
            pass

    def _cold_one(msg):
        """One admitted cold start; ``peers`` (attached by the front door)
        arms the warm-state fetch race when the transfer estimate wins."""
        try:
            before = ops.launch_counts()
            ticket = server.cold_start(
                msg["model"], msg["x"],
                deadline_s=msg.get("deadline_s"),
                peers=msg.get("peers"))
            res = ticket.result()
            launches = _launched_since(before)
            # the race's closing journal line, when a peer fetch was
            # armed, with the layers the peer won
            events = ticket.job.job.fault_events
            peer = next((dict(e) for e in events
                         if e.get("action") == "fetch_race_end"), None)
            if peer is not None:
                peer["won"] = sum(e.get("action") == "fetch_won"
                                  for e in events)
            _send_result(msg, res, warm=False, launches=launches,
                         peer=peer)
        except Exception as e:
            _send_error(msg, e)

    # warm-run coalescing: requests for a model with an active drainer
    # enqueue and return — the drainer serves every queued same-model
    # request in ONE warm_run_many sweep (the BatchedServer drain pattern)
    warm_pending = {}      # model -> [msg, ...]
    warm_draining = set()  # models with an active drainer thread
    warm_lock = threading.Lock()

    def handle_cold_start(msg):
        model = msg["model"]
        with warm_lock:
            warm_pending.setdefault(model, []).append(msg)
            if model in warm_draining:
                return
            warm_draining.add(model)
        while True:
            with warm_lock:
                batch = warm_pending.pop(model, [])
                if not batch:
                    warm_draining.discard(model)
                    return
            try:
                before = ops.launch_counts()
                results = server.warm_run_many(model,
                                               [m["x"] for m in batch])
                launches = _launched_since(before)
            except Exception as e:
                for m in batch:
                    _send_error(m, e)
                continue
            if results is not None:
                for i, (m, res) in enumerate(zip(batch, results)):
                    try:
                        _send_result(m, res, warm=True,
                                     launches=launches if i == 0 else {},
                                     batched=len(batch))
                    except OSError:
                        pass
                continue
            # not resident: each request cold-starts on its own thread
            # (admission blocks; the drainer must keep draining)
            for m in batch:
                threading.Thread(target=_cold_one, args=(m,),
                                 name=f"worker-req-{m.get('rid')}",
                                 daemon=True).start()

    def _fault_dict(e):
        if isinstance(e, Fault):
            return e.describe()
        return {"type": type(e).__name__, "msg": f"{type(e).__name__}: {e}"}

    while True:
        try:
            msg = recv_msg(sock)
        except Exception:
            msg = None
        if msg is None:
            break   # front door hung up
        t = msg.get("type")
        if t == "add_model":
            handle_add_model(msg)
        elif t == "cold_start":
            # own thread: cold starts block at admission and must not
            # stall the recv loop (or each other)
            threading.Thread(target=handle_cold_start, args=(msg,),
                             name=f"worker-req-{msg.get('rid')}",
                             daemon=True).start()
        elif t == "drain":
            ok = server.drain(timeout=msg.get("timeout_s"))
            try:
                send_msg(sock, {"type": "drained", "ok": ok}, send_lock)
            except OSError:
                break
        elif t == "shutdown":
            break
    stop.set()
    warm.close()
    try:
        sock.close()
    except OSError:
        pass
    pool.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
