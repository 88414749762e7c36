"""Cold-LLM bridge: engine-streamed prefill → BatchedServer decode — the
port of ``repro/executor/llm_bridge.py``.

A cold LLM start becomes a first-token-optimal pipeline:

  1. the cold task graph streams block weights from disk and *executes the
     prefill as layers stage* (execute-as-you-load): early blocks compute
     the prompt while later blocks are still being read/transformed — the
     first token is sampled from the streamed prefill's logits;
  2. per-layer ``pack`` tasks — appended to the same task graph — convert
     each block's staged weights into the ``BatchedServer``'s decode param
     layout (deployed dtype, the transformer's param tree). A layer's pack
     depends on its *execute*, never just its stage: decode-path packing
     must not compete with the critical exec chain for the first token, so
     the last layer's decode prep always completes after the first token
     is out;
  3. once every pack landed, the stacked decode params feed a
     ``BatchedServer`` that replays the prompt (+ the already-emitted first
     token) into a KV slot and continues decoding.

On the card a pack runs on a stream of its own: it waits for the layer's
staging copy (``staging.consume``), dequantizes a ``:q8``/``:q4`` group
with the ``dequant_int8``/``dequant_int4`` kernels (``llm_graph._dequant``,
the reference's ``q·s`` in f32 bit for bit) and casts to ``cfg.dtype``, and
synchronizes before the task ends, so the ``pack`` trace is the real work.
The stacked params are made on that stream too. The packed params are
handed to ``ColdServer.register_packed_state``, so a sibling worker's
warm-state fetch can take them (``executor/warmstate.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import ColdEngine
from repro_torch.core.llm_graph import _dequant
from repro_torch.core.pipeline import RunResult
from repro_torch.core.staging import consume
from repro_torch.device import new_stream, on_stream, sync
from repro_torch.executor.graph import PREP_KINDS
from repro_torch.serving.server import BatchedServer, Request


@dataclass
class ColdLLMResult:
    tokens: List[int]                 # first token + decoded continuation
    first_token: int
    first_token_s: float              # job clock: streamed-prefill logits out
    last_weight_prep_s: float         # last read/transform/stage trace end
    decode_prep_s: float              # last 'pack' end (per-layer decode prep)
    decode_ready_s: float             # params stacked + KV slot prefilled
    overlapped_layers: int            # preps still unfinished at first execute
    overlapped_packs: int             # packs started before the exec chain ended
    decode_steps: int = 0             # decode_step calls (replay + decode)
    decode_s: float = 0.0             # wall time of the decode after ready
    decode_ticks: int = 0             # decode_step calls timed in decode_s
    run: RunResult = field(repr=False, default=None)

    @property
    def first_token_before_last_prep(self) -> bool:
        """Token 1 precedes the completion of the last layer's decode-path
        prep. NOTE: this holds *by scheduling policy* (each pack depends on
        its layer's execute, so packing can never delay the exec chain) —
        it documents the policy, it is not evidence of overlap. The
        overlap evidence is ``overlapped_layers`` (weight preps in flight
        when the exec chain started) and ``overlapped_packs`` (decode-path
        packs running concurrently with the exec chain)."""
        return self.first_token_s < self.decode_prep_s


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _pack_params(cfg: ArchConfig, packed: Dict[str, Dict[str, Any]]):
    """Stack per-layer packed weights into the transformer's decode tree."""
    blocks = []
    for i in range(cfg.num_layers):
        w = packed[f"block{i:03d}"]
        attn = {k: w[k] for k in ("wq", "wk", "wv", "wo")}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = w["q_norm"], w["k_norm"]
        blocks.append({"ln1": w["ln1"], "ln2": w["ln2"], "attn": attn,
                       "mlp": {k: w[k]
                               for k in ("w_gate", "w_up", "w_down")}})
    params: Dict[str, Any] = {
        "embed": packed["embed"]["embed"],
        "final_norm": packed["lm_head"]["final_norm"],
        "blocks": _stack(blocks),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = packed["lm_head"]["w"]
    return params


def cold_start_llm(
    engine: ColdEngine,
    cfg: ArchConfig,
    prompt: np.ndarray,               # (S,) int32 token ids
    *,
    max_new_tokens: int = 8,
    n_little: int = 3,
    server: Optional[Any] = None,     # ColdServer for admission (optional)
    model_name: Optional[str] = None,
) -> ColdLLMResult:
    """Cold-start a ``build_llm_graph`` engine and serve ``max_new_tokens``
    greedily on the engine's device; see the module docstring for the
    pipeline."""
    assert engine.plan is not None, "decide() first"
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    x = prompt[None, :]
    dtype = getattr(torch, cfg.dtype)
    packed: Dict[str, Dict[str, Any]] = {}
    specs = {l.spec.name: l.spec for l in engine.layers}
    pack_stream = new_stream(engine.device)

    def hook(graph, weights, lock):
        # decode-path packing: one task per weighted layer, scheduled after
        # the layer's execute so it never delays the exec chain; 'any'
        # affinity — idle littles pack early blocks while later blocks
        # still prep/execute
        for t in [t for t in graph.tasks if t.kind == "execute"]:
            name = t.layer

            def fn(name=name):
                with lock:
                    w = weights.get(name) or {}
                with on_stream(pack_stream):
                    # quantized entries stage as companion groups (base:q8 /
                    # base:q4 + base:qscale); decode wants the logical
                    # tensors (the reference's _expand_quantized), and the
                    # spec recovers an odd K that int4 packing rounded up
                    w = _dequant(consume(w, pack_stream), specs[name])
                    out = {k: v.to(dtype) for k, v in w.items()}
                sync(pack_stream)
                packed[name] = out

            if graph.task(name, "stage") is not None:   # weighted layers only
                graph.add(name, "pack", affinity="any", deps=(t.tid,), fn=fn)

    if server is not None:
        ticket = server.cold_start(model_name, x, n_little=n_little,
                                   graph_hook=hook)
        job, res = ticket.job, ticket.result()
    else:
        job = engine.submit_cold(x, n_little=n_little, graph_hook=hook)
        res = job.result()

    # (1, S, V) float32 logits, finished on the exec stream
    first_token = int(torch.argmax(res.output[0, -1]))
    exec_traces = [t for t in res.traces if t.kind == "execute"]
    first_token_s = max(t.end for t in exec_traces)
    first_exec_start = min(t.start for t in exec_traces)
    prep_traces = [t for t in res.traces if t.kind in PREP_KINDS]
    last_weight_prep_s = max(t.end for t in prep_traces)
    pack_traces = [t for t in res.traces if t.kind == "pack"]
    decode_prep_s = max(t.end for t in pack_traces)
    overlapped = sum(1 for t in prep_traces if t.end > first_exec_start)
    overlapped_packs = sum(1 for t in pack_traces if t.start < first_token_s)

    # packed decode params are now "present" on this worker: register them
    # with the ColdServer so sibling workers' warm-state fetches can ride
    # them over the transfer stream (the ``__packed__`` pseudo-layer),
    # flattened to "layer/key" so they cross the wire as plain tensors
    if server is not None and model_name is not None:
        flat = {f"{lname}/{k}": v
                for lname, kv in packed.items() for k, v in kv.items()}
        server.register_packed_state(model_name, flat)

    # decode continuation: stack params, replay prompt + token 1 into a KV
    # slot, decode the rest greedily; the KV allocation draws from the
    # ColdServer's shared memory budget when one is serving this request
    with on_stream(pack_stream):
        params = _pack_params(cfg, packed)
    sync(pack_stream)
    srv = BatchedServer(params, cfg, max_batch=1,
                        max_len=int(prompt.size + max_new_tokens + 2),
                        budget=(server.budget if server is not None
                                else None),
                        device=engine.device)
    tokens = [first_token]
    decode_s = 0.0
    ready_steps = 0
    if max_new_tokens > 1:
        req = Request(rid=0,
                      prompt=np.concatenate([prompt, [first_token]]),
                      max_new_tokens=max_new_tokens - 1)
        srv.submit(req)
        # admit: replays the prompt into the KV slot, then the first tick
        srv.step()
        # decode-ready = params stacked + KV slot prefilled (NOT the full
        # decode drain — that scales with max_new_tokens)
        decode_ready_s = time.perf_counter() - job.t0
        ready_steps = srv.decode_steps
        srv.run_until_drained()
        decode_s = time.perf_counter() - job.t0 - decode_ready_s
        assert req.done_s is not None, "decode did not drain"
        tokens += [int(tk) for tk in req.out_tokens]
    else:
        decode_ready_s = time.perf_counter() - job.t0
    srv.close()     # return the KV reservation to the shared budget

    return ColdLLMResult(
        tokens=tokens, first_token=first_token,
        first_token_s=first_token_s,
        last_weight_prep_s=last_weight_prep_s,
        decode_prep_s=decode_prep_s, decode_ready_s=decode_ready_s,
        overlapped_layers=overlapped, overlapped_packs=overlapped_packs,
        decode_steps=srv.decode_steps, decode_s=decode_s,
        decode_ticks=srv.decode_steps - ready_steps, run=res,
    )
