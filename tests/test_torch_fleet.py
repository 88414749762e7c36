"""The port's front-door fleet (``executor.frontdoor``/``worker``) on the CPU.

* The wire: ``send_msg`` frames a dict holding numpy arrays in the same
  bytes as the reference's, and each side reads the other's frames;
  ``rebuild_fault`` turns the reference's ``describe()`` into the port's
  typed fault.
* Admission, lanes and routing (``tests/test_frontdoor.py``'s cases):
  shedding before queuing, the interactive reserve, routing by warmth and
  by the peer transfer estimate, failover at the lane head.
* End to end with two CPU workers (one measured plan, decided under the
  workers' emulated edge disk, pinned as ``plan.json`` in every worker's
  store, so every worker and restart holds it): spawn, a cold start from
  disk, SIGKILL mid cold start, failover, restart, a cold start raced
  against the sibling's RAM; the outputs are bitwise equal across
  workers, after the failover and whether peer- or disk-served, and
  within rtol 1e-5, atol 1e-6 of the JAX package's ``ColdServer`` on the
  same weights; each result's launches are its own request's.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as ref_faults  # noqa: E402
from repro.executor import frontdoor as RF  # noqa: E402
from repro_torch.executor.frontdoor import (  # noqa: E402
    BATCH, INTERACTIVE, FrontDoor, FrontDoorRequest, _Worker, rebuild_fault,
    recv_msg, send_msg,
)
from repro_torch.executor import frontdoor as PF  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    DeadlineExceeded, ModelQuarantined, WorkerLost,
)


# -- wire format -------------------------------------------------------------

def _wire(send, msg):
    a, b = socket.socketpair()
    try:
        send(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_send_msg_bytes_equal_the_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    msg = {"type": "result", "rid": 7, "output": x, "total_s": 0.5,
           "ids": np.array([3, 1], np.int32), "peers": [{"port": 1}]}
    assert _wire(send_msg, msg) == _wire(RF.send_msg, msg)


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_recv_msg_reads_either_side(sender):
    a, b = socket.socketpair()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    send = send_msg if sender == "port" else RF.send_msg
    recv = RF.recv_msg if sender == "port" else recv_msg
    send(a, {"type": "result", "rid": 7, "output": x}, threading.Lock())
    for i in range(3):
        send(a, {"i": i})
    got = recv(b)
    assert got["rid"] == 7
    np.testing.assert_array_equal(got["output"], x)
    assert [recv(b)["i"] for _ in range(3)] == [0, 1, 2]
    a.close()
    assert recv(b) is None  # clean EOF -> None, not an exception
    b.close()


@pytest.mark.parametrize("fault", [
    ref_faults.DeadlineExceeded("late", site="watchdog"),
    ref_faults.ModelQuarantined("sick", retry_after=1.5),
    ref_faults.ReadFault("torn", layer="conv1"),
    ref_faults.FetchFault("crc", site="warmstate.chunk", layer="conv2"),
    ref_faults.WorkerLost("gone"),
], ids=lambda f: type(f).__name__)
def test_rebuild_fault_of_the_references_describe(fault):
    d = fault.describe()
    e = rebuild_fault(d)
    assert type(e).__name__ == type(fault).__name__
    assert type(e).__module__ == "repro_torch.faults"
    for k in ("layer", "kernel", "site", "retry_after"):
        assert getattr(e, k) == d.get(k)
    assert isinstance(rebuild_fault({"type": "ValueError", "msg": "x"}),
                      RuntimeError)
    assert isinstance(rebuild_fault({}), RuntimeError)


# -- admission: shed before queuing (no workers needed) ----------------------

@pytest.fixture
def door(tmp_path):
    fd = FrontDoor(tmp_path / "fd", n_workers=2, device="cpu")
    fd._models["m"] = {"name": "m", "builder": "x:y", "kwargs": {}}
    return fd


def test_front_door_requires_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        FrontDoor(tmp_path / "fd")


def test_shed_quarantined_model_typed(door):
    door._quarantine["m"] = time.monotonic() + 10.0
    with pytest.raises(ModelQuarantined) as ei:
        door.request("m", None)
    assert ei.value.retry_after is not None
    assert door.stats["shed_quarantine"] == 1
    assert not door._queues[INTERACTIVE]


def test_shed_budget_below_rpc_floor_typed(door):
    with pytest.raises(DeadlineExceeded):
        door.request("m", None, deadline_s=door.rpc_overhead_s / 2)
    assert door.stats["shed_deadline"] == 1
    assert not door._queues[INTERACTIVE]


def test_shed_on_estimated_queue_delay(door):
    door._svc_ewma["m"] = 0.2
    for _ in range(12):
        door._queues[BATCH].append(object())
    with pytest.raises(DeadlineExceeded):
        door.request("m", None, deadline_s=1.0, lane=BATCH)
    door._svc_ewma.clear()
    req = door.request("m", None, deadline_s=1.0, lane=BATCH)
    assert req in door._queues[BATCH]


def test_unknown_model_and_lane_rejected(door):
    with pytest.raises(KeyError):
        door.request("nope", None)
    with pytest.raises(ValueError):
        door.request("m", None, lane="bulk")


# -- routing + lane policy (fabricated workers) ------------------------------

def _fake_worker(wid, *, alive=True, in_flight=0, resident=(), served=(),
                 warm_port=None, resident_bytes=0, link=0.0):
    w = _Worker(wid)
    w.alive = alive
    w.ready_models = {"m"}
    w.warm_port = warm_port
    w.health = {"resident": list(resident),
                "served": {m: 1 for m in served},
                "resident_model_bytes": {m: resident_bytes
                                         for m in resident},
                "link_bytes_per_s": link}
    for i in range(in_flight):
        w.in_flight[-(i + 1)] = object()
    return w


def test_routing_prefers_resident_then_served_then_least_loaded(tmp_path):
    fd = FrontDoor(tmp_path / "fd", n_workers=3, max_inflight_per_worker=4,
                   device="cpu")
    fd._workers["w0"] = _fake_worker("w0", in_flight=0)
    fd._workers["w1"] = _fake_worker("w1", in_flight=3, served=("m",))
    fd._workers["w2"] = _fake_worker("w2", in_flight=3, resident=("m",))
    assert fd._route_locked("m").wid == "w2"
    fd._workers["w2"].health["resident"] = []
    assert fd._route_locked("m").wid == "w1"
    fd._workers["w1"].health["served"] = {}
    assert fd._route_locked("m").wid == "w0"
    # a respawned worker that has not confirmed the model is no candidate,
    # pinned or not
    fd._workers["w0"].ready_models = set()
    assert fd._route_locked("m").wid == "w1"
    assert fd._route_locked("m", pinned="w0").wid == "w1"
    for w in fd._workers.values():
        w.alive = False
    assert fd._route_locked("m") is None


def test_routing_sends_to_a_cold_worker_when_the_peer_beats_its_disk(
        tmp_path, monkeypatch):
    """A busy resident donor against an idle cold worker: once the
    service time is known, the cold worker's peer transfer estimate wins,
    and its dispatch carries the donor as its peer."""
    fd = FrontDoor(tmp_path / "fd", n_workers=2, max_inflight_per_worker=4,
                   device="cpu")
    fd._workers["w0"] = _fake_worker("w0", in_flight=3, resident=("m",),
                                     warm_port=4242, resident_bytes=10_000,
                                     link=1e9)
    fd._workers["w1"] = _fake_worker("w1")
    fd._svc_ewma["m"] = 1.0
    assert fd._transfer_donors_locked("m") == [("w0", 10_000, 1e9)]
    assert fd._route_locked("m").wid == "w1"
    # without a reachable donor the cold worker pays 3x its disk
    fd._workers["w0"].warm_port = None
    assert fd._route_locked("m").wid == "w0"
    fd._workers["w0"].warm_port = 4242
    sent = []
    fd._workers["w1"].sock = object()
    monkeypatch.setattr(PF, "send_msg",
                        lambda sock, msg, lock=None: sent.append(msg))
    fd._send_request(FrontDoorRequest(1, "m", None, INTERACTIVE, None),
                     fd._workers["w1"])
    assert sent[0]["peers"] == [{"host": "127.0.0.1", "port": 4242,
                                 "resident_bytes": 10_000,
                                 "link_bytes_per_s": 1e9}]


def test_batch_lane_leaves_interactive_reserve(tmp_path):
    fd = FrontDoor(tmp_path / "fd", n_workers=2, max_inflight_per_worker=1,
                   interactive_reserve=1, device="cpu")
    fd._workers["w0"] = _fake_worker("w0")
    fd._workers["w1"] = _fake_worker("w1", in_flight=1)
    fd._models["m"] = {"name": "m"}
    fd._queues[BATCH].append(FrontDoorRequest(1, "m", None, BATCH, None))
    assert fd._pick_locked() is None
    assert len(fd._queues[BATCH]) == 1
    fd._queues[INTERACTIVE].append(
        FrontDoorRequest(2, "m", None, INTERACTIVE, None))
    req, w = fd._pick_locked()
    assert req.lane == INTERACTIVE and w.wid == "w0"


def test_failover_requeues_at_lane_head_then_worker_lost(tmp_path):
    fd = FrontDoor(tmp_path / "fd", n_workers=2, max_failovers=1,
                   device="cpu")
    w = _fake_worker("w0")
    fd._workers["w0"] = w
    young = FrontDoorRequest(1, "m", None, INTERACTIVE, None)
    young.attempts = 1
    spent = FrontDoorRequest(2, "m", None, INTERACTIVE, None)
    spent.attempts = 2
    w.in_flight = {1: young, 2: spent}
    fd._queues[INTERACTIVE].append(
        FrontDoorRequest(3, "m", None, INTERACTIVE, None))
    fd._on_worker_lost(w)
    assert not w.in_flight
    assert fd._queues[INTERACTIVE][0] is young
    assert spent.done()
    with pytest.raises(WorkerLost):
        spent.result(0)
    assert fd.stats["failovers"] == 1 and fd.stats["failover_lost"] == 1


# -- end-to-end: spawn real workers, kill one, fail over, race ---------------

def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# the workers' emulated edge disk: the tiny model's local reads take
# ~0.1 s, which the pinned plan's read costs carry, so the race arms
FLEET_DISK_BYTES_PER_S = 2e6


def _pin_plan(tmp_path, x, model, wids):
    """Decide once, with measured profiles, under the workers' emulated
    disk, and write the plan into every worker's store before
    ``add_model``: each worker and restart then serves this one plan."""
    from repro_torch.core.engine import ColdEngine
    from repro_torch.ioengine import IOEngine
    from repro_torch.models.cnn import build_cnn

    layers, _ = build_cnn("mobilenet", image=16, width=0.25)
    io = IOEngine()
    io.set_sim_read_bandwidth(FLEET_DISK_BYTES_PER_S)
    try:
        eng = ColdEngine(layers, tmp_path / "plan", store_fmt="super",
                         io_engine=io, device="cpu")
        eng.decide(x, n_little=2)
    finally:
        io.close()
    plan = (tmp_path / "plan" / "plan.json").read_text()
    for wid in wids:
        d = tmp_path / "fd" / wid / model
        d.mkdir(parents=True)
        (d / "plan.json").write_text(plan)
    return eng


def test_fleet_chaos_end_to_end(tmp_path):
    from repro.core.profiler import SyntheticProfiler as RefSynthetic
    from repro.executor.server import ColdServer as RefServer
    from repro.models.cnn import build_cnn as ref_build_cnn

    layers, x = ref_build_cnn("mobilenet", image=16, width=0.25)
    iso = RefServer(tmp_path / "iso", n_little=2)
    iso.add_model("mnet", layers, store_fmt="super")
    iso.engines["mnet"].profiler_factory = RefSynthetic
    iso.decide("mnet", x, n_little=2, calibrate_interference=False)
    ref = np.asarray(iso.cold_start("mnet", x).result(120).output)

    from repro_torch.core.scheduler import transfer_estimate

    pinned = _pin_plan(tmp_path, x, "mnet", ("w0", "w1"))
    # the emulated disk's read costs price the plan above the transfer
    # estimate of the model's bytes over an unmeasured link: the race arms
    assert pinned.plan.est_makespan > transfer_estimate(
        pinned.store.model_bytes())
    fd = FrontDoor(tmp_path / "fd", n_workers=2, device="cpu",
                   spawn_timeout_s=120.0,
                   worker_args={"n_little": 2, "n_big": 1,
                                "store_fmt": "super",
                                "sim_disk_bytes_per_s":
                                    FLEET_DISK_BYTES_PER_S})
    try:
        fd.start()
        fd.add_model("mnet", "repro_torch.models.cnn:build_cnn",
                     name="mobilenet", image=16, width=0.25)
        req = fd.request("mnet", x, deadline_s=120.0, worker="w0")
        _wait(lambda: req.worker is not None, 30, "a dispatch")
        victim = req.worker
        fd.kill_worker(victim)                    # SIGKILL mid cold start
        res = req.result(timeout=120)
        assert res["worker"] != victim            # a sibling served it
        assert not res["warm"] and res["peer"] is None
        np.testing.assert_allclose(res["output"], ref, rtol=1e-5, atol=1e-6)

        _wait(lambda: fd.health()["workers"][victim]["alive"]
              and "mnet" in fd._workers[victim].ready_models, 60,
              "the victim's restart")
        h = fd.health()
        assert h["stats"]["worker_restarts"] >= 1
        assert h["stats"]["failovers"] >= 1
        assert sum(w["in_flight"] for w in h["workers"].values()) == 0
        assert sum(h["queues"].values()) == 0

        # the restarted victim cold-starts racing the sibling's RAM
        donor = res["worker"]
        _wait(lambda: "mnet" in (fd._workers[donor].health.get("resident")
                                 or ()), 30, "the donor's residency")
        raced = fd.request("mnet", x, deadline_s=120.0,
                           worker=victim).result(120)
        assert raced["worker"] == victim and not raced["warm"]
        assert raced["peer"]["layers_fetched"] >= raced["peer"]["won"] > 0
        assert raced["peer"]["crc_failures"] == 0
        np.testing.assert_array_equal(raced["output"], res["output"])
        # warm on both workers now: bitwise equal too
        for wid in ("w0", "w1"):
            again = fd.request("mnet", x, deadline_s=120.0,
                               worker=wid).result(120)
            assert again["warm"]
            np.testing.assert_array_equal(again["output"], res["output"])
        # CPU tensors take the plain versions: nothing launched
        assert not any(raced["launches"].values())
    finally:
        fd.shutdown()
    for w in fd._workers.values():
        assert w.proc is None or w.proc.poll() is not None


# -- one plan across a fleet: priced at the emulated disk, pinned by file ----

def test_decide_prices_reads_at_the_emulated_disk(tmp_path):
    """Under an IO engine that emulates an edge disk, every profiled read
    takes at least its bytes over the disk's bandwidth (the runtime's
    paced reads do), and co-reads on the one emulated device interfere."""
    from repro_torch.core.engine import ColdEngine
    from repro_torch.ioengine import IOEngine
    from repro_torch.models.cnn import build_cnn

    layers, x = build_cnn("mobilenet", image=16, width=0.25)
    io = IOEngine()
    io.set_sim_read_bandwidth(FLEET_DISK_BYTES_PER_S)
    try:
        eng = ColdEngine(layers, tmp_path / "m", store_fmt="super",
                         io_engine=io, device="cpu")
        stats = eng.decide(x, n_little=2)
    finally:
        io.close()
    weighted = [ps for ps in eng.profiles.values() if ps[0].raw_bytes]
    assert weighted
    for ps in weighted:
        for p in ps:
            assert p.read_raw_s >= p.raw_bytes / FLEET_DISK_BYTES_PER_S
            assert p.read_cached_s >= \
                p.transformed_bytes / FLEET_DISK_BYTES_PER_S
    assert stats["io_interference"] > 1.5
    assert stats["est_makespan_s"] > (
        eng.store.model_bytes() / FLEET_DISK_BYTES_PER_S / 2)


def test_adopted_plan_json_materializes_its_cache(tmp_path):
    """A ``plan.json`` written into a fresh store (how a fleet pins one
    plan) is adopted with its cache entries materialized and the layer
    inputs traced: the cold start reads the entries through the IO
    engine, recomputes and traces nothing, and equals the deciding
    engine's."""
    from dataclasses import replace

    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.profiler import SyntheticProfiler
    from repro_torch.ioengine import IOEngine
    from repro_torch.models.cnn import build_cnn

    layers, x = build_cnn("mobilenet", image=16, width=0.25)
    a = ColdEngine(layers, tmp_path / "a", store_fmt="super", device="cpu")
    a.profiler_factory = SyntheticProfiler
    a.decide(x, n_little=2, calibrate_interference=False)
    a.set_plan(replace(a.plan, choices=[
        replace(c, use_cache=bool(l.spec.weight_shapes))
        for l, c in zip(layers, a.plan.choices)]))
    a._materialize_cache()
    (tmp_path / "a" / "plan.json").write_text(
        json.dumps({"plan": a.plan.to_dict()}))
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "plan.json").write_text(
        (tmp_path / "a" / "plan.json").read_text())
    layers_b, _ = build_cnn("mobilenet", image=16, width=0.25)
    io = IOEngine()
    try:
        b = ColdEngine(layers_b, tmp_path / "b", store_fmt="super",
                       io_engine=io, device="cpu")
        assert not any(b.store.has_cached(l.spec.name, c.kernel)
                       for l, c in zip(layers_b, a.plan.choices))
        b.adopt_plan(x, n_little=2)
        assert b.plan.to_dict() == a.plan.to_dict()
        cached = [(l.spec.name, c.kernel) for l, c in zip(layers_b,
                                                          b.plan.choices)
                  if c.use_cache]
        assert cached and all(b.store.has_cached(*lc) for lc in cached)
        traces = []
        trace = b._trace_shapes
        b._trace_shapes = lambda x_: traces.append(1) or trace(x_)
        out = b.run_cold(x, n_little=2).output
        assert not traces
        # the cached entries are read through the IO engine (an emulated
        # disk paces them), not around it
        assert io.stats["bytes_submitted"] >= sum(
            b.store.cached_bytes(*lc) for lc in cached) > 0
    finally:
        io.close()
    assert not b.repairs.counts().get("cache_recompute")
    assert torch.equal(out, a.run_cold(x, n_little=2).output)
