"""The port's peer warm-state transfer (``executor.warmstate``, the race in
``core.pipeline``, the peer parts of ``executor.server``) on the CPU.

Every server here decides on ``SyntheticProfiler`` profiles without the
wall-clock interference calibration, so every server holds one plan and
outputs compare bit for bit (the reference's own race tests re-run
``decide()`` on wall-clock profiles). Where a race must be won by the
peer, the fetching server's reads go through an ``IOEngine`` of its own
that emulates a slow edge disk.

* The wire: a fetch round trip is bit-identical (an f32 model's layers, a
  bf16 tensor and the ``__packed__`` params of a cold LLM start); the
  port's server sends the same frames, byte for byte, as the reference's
  for the same state.
* The race: bit-identical whether the peer or the disk serves, journaled;
  a CRC corruption and an injected fetch fault fall back bit-identically
  and leak no ``TransferCharge``; memory pressure refuses; a slow peer is
  declined; an abandoned paced read unblocks.
* ``compile_plan``'s ``fetch_remote`` tasks equal the reference's.
"""
import os
import socket
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bf16  # noqa: E402
from repro_torch.core.profiler import SyntheticProfiler  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    DEFAULT_LINK_BYTES_PER_S, Plan, transfer_estimate,
)
from repro_torch.executor.frontdoor import recv_msg, send_msg  # noqa: E402
from repro_torch.executor.graph import compile_plan  # noqa: E402
from repro_torch.executor.server import ColdServer  # noqa: E402
from repro_torch.executor.warmstate import (  # noqa: E402
    PACKED_LAYER, PeerFetcher, WarmStateServer,
)
from repro_torch.faults import (  # noqa: E402
    FaultInjector, FetchFault, TransientFault,
)
from repro_torch.ioengine import IOEngine  # noqa: E402
from repro_torch.models.cnn import build_cnn  # noqa: E402

torch.set_num_threads(1)

# an emulated edge disk for the fetching server: the tiny model's local
# reads then take ~0.1 s, long enough for the peer stream to win layers
SLOW_DISK_BYTES_PER_S = 2e6


def _mk_server(root, **kw):
    """One ColdServer with 'mnet' registered and decided on the super-
    bundle store. build_cnn is seed-deterministic and the plan synthetic,
    so every server built this way holds bit-identical weights and plan."""
    layers, x = build_cnn("mobilenet", image=16, width=0.25)
    srv = ColdServer(root, n_little=2, max_concurrent_preps=2, device="cpu",
                     **kw)
    eng = srv.add_model("mnet", layers, store_fmt="super")
    eng.profiler_factory = SyntheticProfiler
    srv.decide("mnet", x, n_little=2, calibrate_interference=False)
    return srv, x


@pytest.fixture(scope="module")
def donor():
    """Server A: model resident (one completed cold start) + its warm-state
    endpoint, shared by the read-only tests in this module."""
    root = tempfile.mkdtemp(prefix="torch_warmstate_donor_")
    srv, x = _mk_server(root)
    ref = srv.cold_start("mnet", x).result(60).output.numpy()
    warm = WarmStateServer(srv)
    yield srv, warm, x, ref
    warm.close()


@pytest.fixture
def slow_disk():
    eng = IOEngine()
    eng.set_sim_read_bandwidth(SLOW_DISK_BYTES_PER_S)
    yield eng
    eng.close()


def _peers(warm, resident_bytes=1, link_bytes_per_s=1e9):
    """A peer the cost model always arms against: tiny advertised state
    over a fast link beats any local plan estimate."""
    return [{"host": warm.host, "port": warm.port,
             "resident_bytes": resident_bytes,
             "link_bytes_per_s": link_bytes_per_s}]


def _race_end(ticket):
    ends = [e for e in ticket.job.job.fault_events
            if e.get("action") == "fetch_race_end"]
    assert len(ends) == 1, "every race journals exactly one summary"
    return ends[0]


def _no_leaks(eng):
    assert eng.drain(10.0), "reads or transfer charges leaked"
    assert eng.bytes_in_flight() == 0


# ---------------------------------------------------------------------------
# cost model and graph
# ---------------------------------------------------------------------------
def test_transfer_estimate_units():
    assert transfer_estimate(200_000_000, 200e6) == pytest.approx(1.0)
    assert transfer_estimate(100_000_000, 200e6, rtt_s=0.25) == \
        pytest.approx(0.75)
    assert transfer_estimate(DEFAULT_LINK_BYTES_PER_S, 0.0) == \
        pytest.approx(1.0)
    assert transfer_estimate(0, 200e6) == 0.0


def test_fetch_remote_tasks_match_reference():
    from repro.core.scheduler import Plan as RefPlan
    from repro.executor.graph import compile_plan as ref_compile

    order = ["a", "f", "b", "c"]
    weighted = {"a": True, "f": False, "b": True, "c": True}
    use_cache = {"a": False, "b": True, "c": False}
    kw = dict(weighted=weighted, use_cache=use_cache,
              fetch_layers=["a", "f", "b", "c"])
    graphs = [compile_plan(order, Plan([None] * 4, [0], [[2], [3]], 0.0),
                           **kw),
              ref_compile(order, RefPlan([None] * 4, [0], [[2], [3]], 0.0),
                          **kw)]
    got, want = ([(t.tid, t.layer, t.kind, t.affinity, t.lane,
                   tuple(t.deps)) for t in g.tasks] for g in graphs)
    assert got == want
    fetch = [t for t in graphs[0].tasks if t.kind == "fetch_remote"]
    assert [t.layer for t in fetch] == ["a", "b", "c"]
    assert [t.tid for t in fetch] == [0, 1, 2]
    assert all(t.affinity == "any" and not t.deps for t in fetch)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
def test_fetch_roundtrip_bit_identical(donor):
    srv, warm, _, _ = donor
    state, reason = srv.resident_state_for_transfer("mnet")
    assert reason == "ok" and state
    pf = PeerFetcher("mnet", [(warm.host, warm.port)])
    try:
        for lname, kv in state.items():
            got = pf.fetch(lname)
            assert set(got) == set(kv)
            for k, v in kv.items():
                assert got[k].dtype == v.numpy().dtype
                np.testing.assert_array_equal(got[k], v.numpy())
    finally:
        pf.close()
    assert pf.stats["layers_fetched"] == len(state)
    assert pf.stats["bytes_fetched"] > 0
    assert pf.stats["crc_failures"] == 0


class _State:
    """A stand-in ``ColdServer`` whose resident state is given."""

    def __init__(self, state):
        self.state = state

    def resident_state_for_transfer(self, name, *, packed=False):
        return self.state, "ok"


def _frames(server, model="m"):
    """The raw bytes of every frame a warm-state server sends for one
    fetch, in order."""
    sock = socket.create_connection((server.host, server.port), timeout=10)
    try:
        send_msg(sock, {"type": "fetch", "model": model, "layers": None,
                        "packed": False})
        out = []
        while True:
            head = b""
            while len(head) < 4:
                head += sock.recv(4 - len(head))
            n = int.from_bytes(head, "big")
            body = b""
            while len(body) < n:
                body += sock.recv(n - len(body))
            out.append(head + body)
            import pickle
            if pickle.loads(body)["type"] in ("done", "refuse"):
                return out
    finally:
        sock.close()


def test_frames_equal_the_reference_servers():
    """The same resident state (f32 and bf16) goes out as the same frames,
    byte for byte, from the port's server (torch tensors, bf16 by its bit
    patterns) and the reference's (numpy and ml_dtypes arrays)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from repro.executor.warmstate import WarmStateServer as RefServer

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    h = bf16.from_float(rng.standard_normal((4, 6)))
    ref_state = {"l0": {"w": w, "b": b},
                 "l1": {"h": h.view(np.uint16).view(ml_dtypes.bfloat16)}}
    port_state = {"l0": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                  "l1": {"h": bf16.to_tensor(h)}}
    servers = [WarmStateServer(_State(port_state)),
               RefServer(_State(ref_state))]
    try:
        got, want = (_frames(s) for s in servers)
    finally:
        for s in servers:
            s.close()
    assert len(got) == len(want) == 1 + 3 + 2 + 1
    assert got == want


def test_bf16_and_packed_roundtrip_from_a_cold_llm_start(tmp_path):
    """``cold_start_llm`` on a ColdServer registers the packed decode
    params (bf16); ``fetch_packed`` brings them back bit for bit, bf16 as
    ``bf16.BFLOAT16`` arrays that stage as ``torch.bfloat16``."""
    from repro_torch.configs import get_config
    from repro_torch.core import llm_graph as LG
    from repro_torch.executor import llm_bridge as PB

    cfg = get_config("smollm-360m").reduced(
        num_layers=2, d_model=128, d_ff=256, num_heads=2, num_kv_heads=1,
        head_dim=64, vocab_size=512)
    graph, toks = LG.tiny_llm_graph(2)
    srv = ColdServer(tmp_path, n_little=2, device="cpu")
    eng = srv.add_model("llm", graph)
    eng.profiler_factory = SyntheticProfiler
    srv.decide("llm", toks, n_little=2, calibrate_interference=False)
    PB.cold_start_llm(eng, cfg, toks[0], max_new_tokens=2, n_little=2,
                      server=srv, model_name="llm")
    packed = srv._packed_state["llm"]
    assert any(v.dtype == torch.bfloat16 for v in packed.values())
    assert srv.budget.used_by("packed:llm") == sum(
        int(v.nbytes) for v in packed.values())
    warm = WarmStateServer(srv)
    pf = PeerFetcher("llm", [(warm.host, warm.port)])
    try:
        got = pf.fetch_packed()
        # the packed pseudo-layer rides behind the model's own layers
        assert pf._accepted[-1] == PACKED_LAYER
    finally:
        pf.close()
        warm.close()
    assert set(got) == set(packed)
    for k, v in packed.items():
        if v.dtype == torch.bfloat16:
            assert bf16.is_bf16(got[k])
        back = bf16.to_tensor(np.array(got[k]))
        assert back.dtype == v.dtype
        assert torch.equal(back.view(torch.uint8) if back.dtype ==
                           torch.bfloat16 else back,
                           v.view(torch.uint8) if v.dtype == torch.bfloat16
                           else v)


def test_stream_delivers_every_layer(donor):
    srv, warm, _, _ = donor
    state, _ = srv.resident_state_for_transfer("mnet")
    landed, errs = {}, []
    done = threading.Event()
    pf = PeerFetcher("mnet", [(warm.host, warm.port)])
    try:
        def on_layer(name, kv):
            landed[name] = kv
            if len(landed) == len(state):
                done.set()

        assert pf.start_stream(on_layer, on_error=errs.append)
        assert not pf.start_stream(on_layer, on_error=errs.append)
        assert done.wait(10.0), f"stream delivered {len(landed)} layers"
    finally:
        pf.close()
    assert not errs
    assert set(landed) == set(state)


def test_fetch_from_nobody_raises_typed():
    with pytest.raises(FetchFault):
        PeerFetcher("ghost", [("127.0.0.1", 1)], timeout_s=2.0).fetch("l0")


# ---------------------------------------------------------------------------
# the race, end to end (two servers, one process)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("served_by", ["peer", "disk"])
def test_race_bit_identical_and_journaled(donor, tmp_path, slow_disk,
                                          served_by):
    """With the fetching server on a slow disk the peer wins layers; on
    the page cache the disk may win them all. Either way the output is
    the donor's, bit for bit, and the race journals one summary."""
    _, warm, _, ref = donor
    kw = {"io_engine": slow_disk} if served_by == "peer" else {}
    srv_b, x = _mk_server(tmp_path, **kw)
    ticket = srv_b.cold_start("mnet", x, peers=_peers(warm))
    out = ticket.result(60).output.numpy()
    np.testing.assert_array_equal(out, ref)
    assert srv_b.stats["peer_races"] == 1
    end = _race_end(ticket)
    assert end["crc_failures"] == 0 and end["refused"] == 0
    assert srv_b.stats["peer_layers_fetched"] == end["layers_fetched"]
    assert srv_b.stats["peer_bytes_fetched"] == end["bytes_fetched"]
    events = ticket.job.job.fault_events
    if served_by == "peer":
        assert end["layers_fetched"] > 0
        won = [e["layer"] for e in events if e["action"] == "fetch_won"]
        lost = [e["layer"] for e in events if e["action"] == "fetch_lost"]
        assert won, events
        assert len(won) + len(lost) == end["layers_fetched"]
        _no_leaks(slow_disk)
        assert slow_disk.stats["transfer_charges"] > 0
    # the fetched layers' staged tensors are the ones the run kept
    assert srv_b.health()["link_bytes_per_s"] >= 0.0


def test_slow_peer_declined(donor, tmp_path):
    _, warm, _, ref = donor
    srv_b, x = _mk_server(tmp_path)
    sessions = warm.stats["sessions"]
    slow = [{"host": warm.host, "port": warm.port,
             "resident_bytes": 1 << 40, "link_bytes_per_s": 1e3}]
    out = srv_b.cold_start("mnet", x, peers=slow).result(60).output.numpy()
    np.testing.assert_array_equal(out, ref)
    assert srv_b.stats["peer_races"] == 0
    assert srv_b.stats["peer_races_declined"] == 1
    assert warm.stats["sessions"] == sessions


def test_crc_corruption_falls_back_bit_identical(donor, tmp_path, slow_disk):
    """A corrupted chunk surfaces as a typed integrity failure on the
    fetching side and never reaches the weights: the cold start falls
    back to its local chains, bit-identical, and leaks no charge."""
    _, warm, _, ref = donor
    srv_b, x = _mk_server(tmp_path, io_engine=slow_disk)
    warm.corrupt_chunks = 2
    try:
        ticket = srv_b.cold_start("mnet", x, peers=_peers(warm))
        out = ticket.result(60).output.numpy()
    finally:
        warm.corrupt_chunks = 0
    np.testing.assert_array_equal(out, ref)
    assert srv_b.stats["peer_crc_failures"] >= 1
    events = ticket.job.job.fault_events
    assert any(e.get("action") == "fetch_fallback" for e in events)
    _no_leaks(slow_disk)


def test_injected_fetch_fault_falls_back_no_leaks(donor, tmp_path,
                                                  slow_disk):
    _, warm, _, ref = donor
    srv_b, x = _mk_server(tmp_path, io_engine=slow_disk)
    eng = srv_b.engines["mnet"]
    eng.fault_injector = FaultInjector(
        seed=3, rates={"warmstate.fetch": 1.0}, max_faults_per_key=None)
    try:
        ticket = srv_b.cold_start("mnet", x, peers=_peers(warm))
        out = ticket.result(60).output.numpy()
    finally:
        eng.fault_injector = None
    np.testing.assert_array_equal(out, ref)
    events = ticket.job.job.fault_events
    assert any(e.get("action") == "fetch_fallback" for e in events)
    assert _race_end(ticket)["layers_fetched"] >= 1
    _no_leaks(slow_disk)
    # the pool survived the race + fallback: serve again, bit-identical
    srv_b.evict("mnet")
    out2 = srv_b.cold_start("mnet", x, peers=_peers(warm)).result(60)
    np.testing.assert_array_equal(out2.output.numpy(), ref)
    _no_leaks(slow_disk)


def test_refusal_under_memory_pressure(donor):
    srv, warm, _, _ = donor
    total = srv.budget.total
    srv.budget.total = 1
    srv.budget.charge("test:pressure", 2)
    try:
        state, reason = srv.resident_state_for_transfer("mnet")
        assert state is None and "pressure" in reason
        pf = PeerFetcher("mnet", [(warm.host, warm.port)])
        try:
            with pytest.raises(TransientFault):
                pf.fetch("conv0")
        finally:
            pf.close()
        assert pf.stats["refused"] == 1
    finally:
        srv.budget.total = total
        srv.budget.release("test:pressure")
    state, reason = srv.resident_state_for_transfer("mnet")
    assert reason == "ok" and state


def test_refusal_when_not_resident_or_draining(tmp_path):
    srv, x = _mk_server(tmp_path)
    assert srv.resident_state_for_transfer("mnet") == (None, "not resident")
    srv.cold_start("mnet", x).result(60)
    srv.refuse_transfers = True
    assert srv.resident_state_for_transfer("mnet")[0] is None
    srv.refuse_transfers = False
    assert srv.drain(10.0)
    assert srv.resident_state_for_transfer("mnet") == (None, "draining")
    assert srv.stats["transfer_refusals"] == 3


# ---------------------------------------------------------------------------
# abortable paced reads (the race-loser's slot is freed promptly)
# ---------------------------------------------------------------------------
def test_interrupt_unblocks_paced_read(tmp_path):
    from repro_torch.ioengine import ReadAbandoned

    payload = os.urandom(1 << 20)
    p = tmp_path / "blob"
    p.write_bytes(payload)
    eng = IOEngine()
    try:
        eng.set_sim_read_bandwidth(100_000)
        fd = os.open(p, os.O_RDONLY)
        try:
            t = eng.submit(fd, 0, len(payload), key="blob")
            threading.Timer(0.1, t.interrupt).start()
            t0 = time.monotonic()
            with pytest.raises(ReadAbandoned):
                t.wait(5.0)
            assert time.monotonic() - t0 < 2.0
            t.release()
        finally:
            os.close(fd)
        assert eng.drain(5.0)
    finally:
        eng.close()
