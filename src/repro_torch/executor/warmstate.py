"""Peer-to-peer warm-state transfer — cold-start from a sibling's RAM.

Once a model has cold-started *anywhere* in the fleet, every other worker
holds the single most expensive cold-path resource — the post-transform
staged weights — one hop away in a sibling's memory.  This module moves
them: a :class:`WarmStateServer` on each worker serves its ``ColdServer``'s
resident layer state over the same length-prefixed pickle channel the
front door already speaks, and a :class:`PeerFetcher` on the requesting
side streams it in, racing the local ``read→transform→stage`` chains.
The drain runs on the fetcher's OWN background thread
(:meth:`PeerFetcher.start_stream`) so it never occupies a pool worker:
each layer is handed to a callback the moment it lands, which stages it
and cancels the local chain it beat (``CorePool.cancel_tasks``) — first
finisher wins per layer.  The executor graph's ``fetch_remote`` tasks
are the race's instant, cancellable markers: running one (backstop-)
starts the stream, and a local chain that finishes first retires its
layer's still-pending marker.

Protocol (all frames are length-prefixed pickled dicts):

  client → server   ``{"type": "fetch", "model", "layers": [...] | None,
                       "packed": bool}``
  server → client   ``{"type": "refuse", "model", "reason"}``               or
                    ``{"type": "accept", "model", "layers": [...],
                       "total_bytes": int}``
                    then per layer, per tensor key:
                    ``{"type": "chunk", "layer", "key", "dtype", "shape",
                       "data": bytes, "crc": int}``   (CRC-32C over data)
                    ``{"type": "layer_done", "layer", "nkeys": int}``
                    and finally ``{"type": "done", "model"}``

The server refuses — rather than serves a partial answer — whenever the
model is not resident, the server is draining, or its residency budget is
over-committed (memory pressure): a refusal costs the requester one RTT
and the local chain proceeds, while an evicted-mid-stream layer would
cost a stall.  Packed decode params (the LLM bridge's ``BatchedServer``
params) ride the same stream under the reserved layer name
``__packed__`` when the serving worker has registered them.

Client-side integrity and accounting: every chunk's payload is copied
into an ``IOEngine`` pinned-pool slab under a :class:`TransferCharge`
(counts against ``max_read_bytes_in_flight`` — budget pressure
back-pressures the socket), CRC-32C-verified in place, and only then
materialized into a host array, which the executor stages to the device
through the same stage path as a locally read layer.  Any mismatch,
refusal, disconnect, or timeout raises a typed
:class:`~repro_torch.faults.FetchFault` (a ``TransientFault``): the
executor's fetch task swallows it and the local chain — always racing —
remains authoritative, bit-identical by construction.

The port of ``repro/executor/warmstate.py``, with the same protocol and
the same bytes on the wire. The resident state is device tensors: the
server copies each into pinned host memory before its CRC-32C. numpy has
no bfloat16, so a bf16 tensor travels as its uint16 bit patterns under the
dtype name ``"bfloat16"`` (the name the reference sends) and lands as a
``bf16.BFLOAT16`` array, which staging views back as ``torch.bfloat16``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.checkpoint.integrity import crc32c
from repro_torch.core.staging import copy_stream
from repro_torch.executor.frontdoor import recv_msg, send_msg
from repro_torch.faults import FetchFault, TransientFault

#: reserved pseudo-layer name for packed decode params
PACKED_LAYER = "__packed__"


def _crc(data) -> int:
    return int(crc32c(np.frombuffer(data, dtype=np.uint8)))


def host_array(v) -> np.ndarray:
    """A resident value as a contiguous host array. A CUDA tensor is
    copied into pinned host memory first, on the device's staging copy
    stream (the staged tensors are finished: their staging synchronized);
    bf16 comes back as ``bf16.BFLOAT16``."""
    if not isinstance(v, torch.Tensor):
        return np.ascontiguousarray(v)
    t = v.detach()
    if t.is_cuda:
        s = copy_stream(t.device)
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(s):
            h.copy_(t, non_blocking=True)
        s.synchronize()
        t = h
    return bf16.to_numpy(t.contiguous())


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class WarmStateServer:
    """Serves one ``ColdServer``'s resident warm state to sibling workers.

    ``cold_server`` only needs ``resident_state_for_transfer(model,
    packed=...)`` returning ``(state, reason)`` — ``state`` is
    ``{layer: {key: tensor or array}}`` (None = refusal with ``reason``).  One
    daemon accept thread, one daemon thread per peer session; sessions
    are short-lived (one per cold start on the fetching side).
    """

    def __init__(self, cold_server, host: str = "127.0.0.1", port: int = 0):
        self.server = cold_server
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.host, self.port = self._listener.getsockname()[:2]
        self._closed = False
        self._lock = threading.Lock()
        self.stats = {"sessions": 0, "fetches": 0, "refusals": 0,
                      "layers_served": 0, "bytes_served": 0}
        # test hook: corrupt the payload of the first N chunks AFTER the
        # CRC is computed — the client-side integrity gate's chaos lever
        self.corrupt_chunks = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repro-warmstate-accept",
            daemon=True)
        self._accept_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass

    @property
    def endpoint(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- serving -------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self.stats["sessions"] += 1
            threading.Thread(target=self._session, args=(sock,),
                             name="repro-warmstate-session",
                             daemon=True).start()

    def _session(self, sock: socket.socket) -> None:
        try:
            while True:
                msg = recv_msg(sock)
                if msg is None or msg.get("type") == "close":
                    return
                if msg.get("type") == "fetch":
                    self._serve_fetch(sock, msg)
        except OSError:
            pass    # peer gone mid-stream: its fetcher raises FetchFault
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _serve_fetch(self, sock: socket.socket, msg: Dict[str, Any]) -> None:
        model = msg.get("model")
        with self._lock:
            self.stats["fetches"] += 1
        state, reason = self.server.resident_state_for_transfer(
            model, packed=bool(msg.get("packed")))
        if state is None:
            with self._lock:
                self.stats["refusals"] += 1
            send_msg(sock, {"type": "refuse", "model": model,
                            "reason": reason})
            return
        wanted = msg.get("layers")
        if wanted is not None:
            wanted = [n for n in wanted if n in state]
            state = {n: state[n] for n in wanted}
        layers = [n for n, kv in state.items() if kv]
        total = sum(int(a.nbytes)
                    for kv in state.values() for a in kv.values())
        send_msg(sock, {"type": "accept", "model": model,
                        "layers": layers, "total_bytes": total})
        for layer in layers:
            for key, arr in state[layer].items():
                a = host_array(arr)
                data = a.tobytes()
                crc = _crc(data)
                if self.corrupt_chunks > 0:
                    self.corrupt_chunks -= 1
                    b = bytearray(data)
                    b[len(b) // 2] ^= 0xFF
                    data = bytes(b)
                send_msg(sock, {"type": "chunk", "layer": layer, "key": key,
                                "dtype": bf16.dtype_name(a),
                                "shape": a.shape,
                                "data": data, "crc": crc})
                with self._lock:
                    self.stats["bytes_served"] += len(data)
            send_msg(sock, {"type": "layer_done", "layer": layer,
                            "nkeys": len(state[layer])})
            with self._lock:
                self.stats["layers_served"] += 1
        send_msg(sock, {"type": "done", "model": model})


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class PeerFetcher:
    """One cold start's peer-transfer session.

    Two drain modes share the same connection machinery:

    * :meth:`start_stream` — the racing cold path.  A dedicated daemon
      thread opens the connection, requests the whole model, and hands
      each layer's completed state to ``on_layer`` the moment its last
      chunk verifies, so the race against the local disk chains starts
      at submit time and never occupies a pool worker.  ``should_stop``
      (checked between layers) ends the drain early once every layer is
      decided; any wire failure fires ``on_error`` exactly once and the
      local chains — always racing — take over.
    * :meth:`fetch` — synchronous pull of one layer (tests, the packed-
      params side channel).  Callers take turns draining the stream
      under one lock, buffering other layers' completed state until
      their own lands.

    Every failure mode maps to a typed :class:`FetchFault`; after the
    first failure the session is dead and every subsequent ``fetch``
    fails fast (the race never waits on a broken wire).
    """

    def __init__(self, model: str, endpoints: Iterable[Tuple[str, int]], *,
                 io_engine=None, injector=None, timeout_s: float = 30.0):
        self.model = model
        self.endpoints = list(endpoints)
        self.io_engine = io_engine
        self.injector = injector
        self.timeout_s = timeout_s
        self._lock = threading.Lock()       # serializes the stream drain
        self._sock: Optional[socket.socket] = None
        self._started = False
        self._t_connect = 0.0
        self._failed: Optional[BaseException] = None
        self._accepted: Optional[List[str]] = None
        self._stream_done = False
        self._ready: Dict[str, Dict[str, np.ndarray]] = {}
        self._partial: Dict[str, Dict[str, np.ndarray]] = {}
        self._closed = False
        self._streaming = False
        self._stream_thread: Optional[threading.Thread] = None
        self.stats = {"layers_fetched": 0, "bytes_fetched": 0,
                      "crc_failures": 0, "refused": 0,
                      "measured_bytes_per_s": 0.0}

    # -- session -------------------------------------------------------------
    def _fail(self, err: BaseException) -> BaseException:
        self._failed = err
        self._close_sock()
        return err

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._close_sock()

    def _start_locked(self, packed: bool) -> None:
        if self._started:
            return
        self._started = True
        if not self.endpoints:
            raise self._fail(FetchFault(
                f"no peer endpoints for {self.model!r}",
                site="warmstate.fetch"))
        host, port = self.endpoints[0]
        try:
            self._sock = socket.create_connection(
                (host, port), timeout=self.timeout_s)
            self._sock.settimeout(self.timeout_s)
            send_msg(self._sock, {"type": "fetch", "model": self.model,
                                  "layers": None, "packed": packed})
        except OSError as e:
            raise self._fail(FetchFault(
                f"cannot reach peer {host}:{port} for {self.model!r}: {e}",
                site="warmstate.fetch")) from e
        self._t_connect = time.monotonic()
        msg = self._recv()
        if msg.get("type") == "refuse":
            self.stats["refused"] += 1
            raise self._fail(FetchFault(
                f"peer refused {self.model!r}: {msg.get('reason')}",
                site="warmstate.fetch"))
        if msg.get("type") != "accept":
            raise self._fail(FetchFault(
                f"unexpected frame {msg.get('type')!r} from peer",
                site="warmstate.fetch"))
        self._accepted = list(msg.get("layers") or [])

    def _recv(self) -> Dict[str, Any]:
        try:
            msg = recv_msg(self._sock)
        except OSError as e:
            raise self._fail(FetchFault(
                f"peer connection lost mid-stream ({self.model!r}): {e}",
                site="warmstate.fetch")) from e
        if msg is None:
            raise self._fail(FetchFault(
                f"peer closed mid-stream ({self.model!r})",
                site="warmstate.fetch"))
        return msg

    # -- stream draining -----------------------------------------------------
    def _materialize(self, msg: Dict[str, Any]) -> np.ndarray:
        """Chunk payload → array, through the pinned pool + CRC gate."""
        data = msg["data"]
        n = len(data)
        layer = msg.get("layer")
        dtype = bf16.np_dtype(msg["dtype"])
        if self.io_engine is not None:
            charge = self.io_engine.charge(
                n, key=f"{self.model}:{layer}", injector=self.injector)
            try:
                charge.buf.arr[:n] = np.frombuffer(data, dtype=np.uint8)
                view = charge.view(n)
                if int(crc32c(view)) != int(msg["crc"]):
                    self.stats["crc_failures"] += 1
                    raise FetchFault(
                        f"chunk CRC mismatch ({layer}/{msg.get('key')})",
                        site="warmstate.chunk", layer=layer)
                # one copy out of the slab into a heap array the layer
                # owns: the slab recycles at release
                arr = np.array(view.view(dtype).reshape(msg["shape"]))
            finally:
                charge.release()
        else:
            if _crc(data) != int(msg["crc"]):
                self.stats["crc_failures"] += 1
                raise FetchFault(
                    f"chunk CRC mismatch ({layer}/{msg.get('key')})",
                    site="warmstate.chunk", layer=layer)
            arr = np.frombuffer(data, dtype=dtype).reshape(msg["shape"])
        self.stats["bytes_fetched"] += n
        return arr

    def _drain_one_locked(self) -> None:
        msg = self._recv()
        t = msg.get("type")
        if t == "chunk":
            try:
                arr = self._materialize(msg)
            except FetchFault as e:
                raise self._fail(e)
            self._partial.setdefault(msg["layer"], {})[msg["key"]] = arr
        elif t == "layer_done":
            self._ready[msg["layer"]] = self._partial.pop(msg["layer"], {})
            self.stats["layers_fetched"] += 1
        elif t == "done":
            self._stream_done = True
            dt = max(time.monotonic() - self._t_connect, 1e-9)
            self.stats["measured_bytes_per_s"] = (
                self.stats["bytes_fetched"] / dt)
            self._close_sock()
        else:
            raise self._fail(FetchFault(
                f"unexpected frame {t!r} mid-stream", site="warmstate.fetch"))

    # -- background streaming (the racing cold path) -------------------------
    def start_stream(self, on_layer, *, on_error=None,
                     should_stop=None) -> bool:
        """Drain the whole model on a background thread.

        ``on_layer(name, {key: array})`` fires (on the stream thread) the
        moment a layer's last chunk verifies; ``should_stop()`` is polled
        between layers and ends the drain early (e.g. every layer already
        decided locally); ``on_error(FetchFault)`` fires at most once for
        any wire failure — a ``close()``d session reports nothing.
        Idempotent: only the first call starts the thread (returns True);
        a dead/closed/already-streaming session returns False."""
        with self._lock:
            if self._closed or self._failed is not None or self._streaming:
                return False
            self._streaming = True
        th = threading.Thread(
            target=self._stream_loop, args=(on_layer, on_error, should_stop),
            name="repro-warmstate-stream", daemon=True)
        self._stream_thread = th
        th.start()
        return True

    def _stream_loop(self, on_layer, on_error, should_stop) -> None:
        err: Optional[BaseException] = None
        try:
            while True:
                delivered: List[Tuple[str, Dict[str, np.ndarray]]] = []
                with self._lock:
                    if self._closed or self._failed is not None:
                        return
                    self._start_locked(False)
                    if self._stream_done:
                        break
                    self._drain_one_locked()
                    for name in list(self._ready):
                        delivered.append((name, self._ready.pop(name)))
                for name, state in delivered:
                    if self.injector is not None:
                        # per-layer chaos point, same site/key scheme as
                        # the synchronous fetch path
                        self.injector.maybe_fault(
                            "warmstate.fetch", f"{self.model}:{name}")
                    on_layer(name, state)
                if delivered and should_stop is not None and should_stop():
                    with self._lock:
                        self._close_sock()
                    return
        except TransientFault as e:
            with self._lock:
                if self._failed is None:
                    self._fail(e)
                suppressed = self._closed
            err = e
            if not suppressed and on_error is not None:
                on_error(e)
        finally:
            if err is None:
                with self._lock:
                    self._close_sock()

    def fetch(self, layer: str, *, packed: bool = False
              ) -> Dict[str, np.ndarray]:
        """Block until ``layer``'s state has streamed in; returns its
        ``{key: array}`` dict.  Raises :class:`FetchFault` on refusal,
        CRC mismatch, disconnect, timeout, or a layer the peer does not
        hold."""
        if self.injector is not None:
            self.injector.maybe_fault(
                "warmstate.fetch", f"{self.model}:{layer}")
        with self._lock:
            if self._closed:
                raise FetchFault(
                    f"fetch session for {self.model!r} already closed",
                    site="warmstate.fetch")
            if self._failed is not None:
                raise FetchFault(
                    f"fetch session for {self.model!r} already failed: "
                    f"{self._failed}", site="warmstate.fetch",
                    layer=layer) from self._failed
            self._start_locked(packed)
            if layer in self._ready:
                return self._ready.pop(layer)
            if self._accepted is not None and layer not in self._accepted:
                raise FetchFault(
                    f"peer does not hold {layer!r} of {self.model!r}",
                    site="warmstate.fetch", layer=layer)
            while not self._stream_done:
                self._drain_one_locked()
                if layer in self._ready:
                    return self._ready.pop(layer)
            raise self._fail(FetchFault(
                f"stream ended without {layer!r} of {self.model!r}",
                site="warmstate.fetch", layer=layer))

    def fetch_packed(self) -> Dict[str, np.ndarray]:
        """Packed decode params (``__packed__``), when the peer has them."""
        return self.fetch(PACKED_LAYER, packed=True)
