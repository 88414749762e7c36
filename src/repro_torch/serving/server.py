"""Batched serving loop — the port of ``repro/serving/server.py``.

A small but real server: requests enter a queue; the engine admits up to
``max_batch`` concurrent sequences into fixed slots; each scheduler tick
decodes one token for every live slot (one ``decode_step`` for the whole
batch: on the ``decode_attention`` kernel for the dense and moe families,
whose expert FFNs run on ``gmm_blocks``; the recurrent step for ssm; both
for hybrid, whose shared block attends to one cache per application);
finished sequences free their slots for queued requests. A new request's
prompt is replayed token by token through ``decode_step`` into its slot.
The decode state is a flat dict of tensors for every family (KV caches,
conv and SSM states, or both); ``kv_bytes`` counts all of it. Token models
only, as in the reference: an ``embeddings`` or ``vlm`` model (no token
prompt to replay, or a prefix the step cannot take) is refused.

The reference's behaviour is kept as it is, because parity is held to it:
one shared position per ``decode_step`` (slots run in lockstep at the
largest live position), the prompt replay that writes every row's cache
at the replayed position, and a recycled slot that carries on from its
old position.

``jax.jit(decode_step)``, one executable for every position, becomes one
CUDA graph a server: ``(max_batch, max_len)`` is fixed at construction,
and the position goes in as a 0-d tensor, so the step reads nothing
back. Every decode (each prompt token replayed and each tick) copies its
tokens and position into static buffers and replays the graph, which
writes static logits (valid until the next decode). The graph is
captured at the first decode, after one warm-up step (libraries loaded,
lazy initialisation); the state's leaves are copied before the warm-up
and put back after the capture, so both leave it bitwise as it was. The
kernel wrappers count their launches in Python, which a replay never
runs: the warm-up's and the capture's counts are taken back, and each
replay adds the capture's (``ops.add_launch_counts``), so the counters
read as if every step ran eagerly. ``graph=False`` runs the same body
eagerly on the same buffers; so does a server on the CPU, which has no
graphs (the CPU tests run the body the card captures). A Python hook
inside the step (a recorded or replayed routing) would run at capture
only: such a caller passes ``graph=False``. On a card a capture or a
replay that fails raises; nothing falls back to eager.

Sampling stays outside the graph. It draws from an explicit
``torch.Generator`` seeded 0 on the server's device, where the reference
draws from ``jax.random.PRNGKey(0)``: the two give different numbers, so
the port and the reference agree token for token on greedy requests
(temperature 0) only.

``device`` defaults to ``"cuda"`` and raises without a card; decode runs
on the server's own stream there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import new_stream, on_stream, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Sample one token id from (V,) logits. temperature == 0 -> greedy.
    top_k and nucleus (top_p) filters compose."""
    if temperature <= 0.0:
        return torch.argmax(logits)
    logits = logits.to(torch.float32) / temperature
    neg = torch.tensor(-torch.inf, device=logits.device)
    if top_k and top_k < logits.shape[-1]:
        kth = torch.sort(logits).values[-top_k]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p
        cutoff = sorted_logits[torch.argmax((cum >= top_p).to(torch.int32))]
        logits = torch.where(logits < cutoff, neg, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[0]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    out_tokens: List[int] = field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None


def _new_graph():
    return torch.cuda.CUDAGraph()


def _capturing(graph, stream):
    """Capture on ``stream``; other threads may go on using the card."""
    return torch.cuda.graph(graph, stream=stream,
                            capture_error_mode="thread_local")


def _minus(a: dict, b: dict) -> dict:
    return {k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}


class BatchedServer:
    def __init__(self, params, cfg: ArchConfig, *, max_batch: int = 4,
                 max_len: int = 512, budget=None, device="cuda",
                 graph: bool = True):
        """``budget`` (a ``repro_torch.executor.server.MemoryBudget``,
        duck-typed ``reserve``/``release``) charges this server's KV-cache
        allocation to the SAME accounted pool the ColdServer's
        staged-weight LRU draws from. ``close()`` releases the
        reservation. ``params`` move to ``device`` (a no-op for tensors
        already there). ``graph`` replays each decode step from one CUDA
        graph on a card (``False``: eager; the CPU has no graphs)."""
        assert cfg.input_mode == "tokens", "server demo expects token models"
        self.device = resolve_device(device)
        self.stream = new_stream(self.device)
        if self.stream is not None:
            # the caller may still be writing ``params`` on its own stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # the params' copies and the KV state's zero-fill go on the stream
        # that every decode step runs on, so no step can overtake them
        with on_stream(self.stream):
            self.params = T.to_device(params, self.device)
            self.state = T.init_decode_state(cfg, max_batch, max_len,
                                             device=self.device)
            # the step's static inputs: what a graph reads at each replay
            self._tokens = torch.zeros((max_batch, 1), dtype=torch.int64,
                                       device=self.device)
            self._pos = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_bytes = sum(int(t.nbytes) for t in self.state.values())
        self.budget = budget
        self._budget_tag = f"kv:{id(self)}"
        if budget is not None:
            budget.reserve(self._budget_tag, self.kv_bytes)
        self.pos = np.zeros(max_batch, np.int64)        # per-slot position
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        # completed since the last drain; run_until_drained hands the list
        # to the caller (a long-running server must not accumulate every
        # request it ever served)
        self.finished: List[Request] = []
        self.decode_steps = 0                            # decode_step calls
        self._t0 = time.perf_counter()
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.graphed = graph and self.device.type == "cuda"
        self._graph = None
        self._logits = None       # the graph's static output
        self._replay_counts = ({}, {})
        self.captures = 0
        self.capture_s = 0.0

    def _body(self) -> torch.Tensor:
        """The decode step on the static buffers: what a graph captures."""
        logits, _ = T.decode_step(self.params, self.state,
                                  {"tokens": self._tokens}, self._pos,
                                  self.cfg)
        return logits

    def _capture(self) -> None:
        t0 = time.perf_counter()
        start = ops.launch_counts(), ops.gemm_path_counts()
        saved = {k: t.clone() for k, t in self.state.items()}
        self._body()                                     # the warm-up
        before = ops.launch_counts(), ops.gemm_path_counts()
        graph = _new_graph()
        with _capturing(graph, self.stream):
            self._logits = self._body()
        after = ops.launch_counts(), ops.gemm_path_counts()
        self._replay_counts = (_minus(after[0], before[0]),
                               _minus(after[1], before[1]))
        # the warm-up and the capture count as no decode
        ops.add_launch_counts(_minus(start[0], after[0]),
                              _minus(start[1], after[1]))
        for k, t in self.state.items():
            t.copy_(saved[k])
        self._graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _decode(self, batch_tok: np.ndarray, pos: int) -> torch.Tensor:
        with on_stream(self.stream):
            self._tokens.copy_(torch.from_numpy(batch_tok.astype(np.int64)),
                               non_blocking=True)
            self._pos.fill_(int(pos))
            if self.graphed:
                if self._graph is None:
                    self._capture()
                self._graph.replay()
                ops.add_launch_counts(*self._replay_counts)
                logits = self._logits
            else:
                logits = self._body()
        self.decode_steps += 1
        return logits

    def _pick(self, req: Request, logits_row: torch.Tensor) -> int:
        with on_stream(self.stream):
            return int(sample_token(
                logits_row, self._gen, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p))

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.submitted_s = time.perf_counter() - self._t0
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: Request):
        """Feed the prompt token-by-token through decode_step for the slot
        (slot-granular prefill via the batched decode path, as the
        reference does)."""
        self.slot_req[slot] = req
        toks = np.asarray(req.prompt).astype(np.int32)
        for tok in toks:
            batch_tok = np.zeros((self.max_batch, 1), np.int32)
            batch_tok[slot, 0] = tok
            logits = self._decode(batch_tok, int(self.pos[slot]))
            self.pos[slot] += 1
        nxt = self._pick(req, logits[slot, 0])
        req.out_tokens.append(nxt)
        req.first_token_s = time.perf_counter() - self._t0

    def step(self) -> int:
        """One decode tick for all live slots. Returns #live slots."""
        self._admit()
        live = [s for s in range(self.max_batch)
                if self.slot_req[s] is not None]
        if not live:
            return 0
        batch_tok = np.zeros((self.max_batch, 1), np.int32)
        for s in live:
            batch_tok[s, 0] = self.slot_req[s].out_tokens[-1]
        # single shared position per decode_step: the largest live slot
        # position (the reference's lockstep)
        pos = int(max(self.pos[s] for s in live))
        logits = self._decode(batch_tok, pos)
        for s in live:
            self.pos[s] = pos + 1
            req = self.slot_req[s]
            req.out_tokens.append(self._pick(req, logits[s, 0]))
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done_s = time.perf_counter() - self._t0
                self.finished.append(req)
                self.slot_req[s] = None
        return len(live)

    def close(self):
        """Release the KV-cache reservation back to the shared budget.
        Idempotent; the server itself remains usable (the accounting is
        advisory — correctness never depends on it)."""
        if self.budget is not None:
            self.budget.release(self._budget_tag)
            self.budget = None

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until queue and slots are empty; returns every request
        finished since the last drain (in completion order) and clears the
        buffer — ownership passes to the caller."""
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        out, self.finished = self.finished, []
        return out
