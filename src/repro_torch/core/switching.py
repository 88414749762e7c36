"""Kernel switching for continuous inference — §3.5.

K_cold (the scheduler's choices) can be slower at steady state than K_warm
(fastest-execution kernels). In continuous mode the engine:
  1. runs the cold inference with K_cold as usual;
  2. on idle little-core threads, prepares the kernels in K_warm − K_cold
     (read raw + transform into the warm format + stage to the device);
  3. switches layer-by-layer: the 2nd inference uses the warm kernel for
     every layer whose preparation finished, the cold run's resident
     tensors for the rest (paper: 2nd inference ≈ 8% slower, 3rd equal).

The port of ``repro/core/switching.py``. Warm weights are staged through
``core.staging`` onto the device (identity transforms hand back read-only
mmap views, which staging copies, never aliases). A warm inference queues
every layer on the engine's own stream and synchronizes it once, at the
end; on a card each layer's ``OpTrace`` is the device span between two
CUDA events around it (seconds from the inference's first event), where
the reference blocks on every layer. The session builds its two kernel
maps (K_warm, K_cold) once, in ``cold_infer``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set, Tuple

import torch

from repro_torch.core.engine import ColdEngine
from repro_torch.core.pipeline import OpTrace, RunResult
from repro_torch.core.staging import consume, stage_weights
from repro_torch.device import on_stream, sync, to_device
from repro_torch.executor.graph import TaskGraph
from repro_torch.executor.pool import Job


@dataclass
class ContinuousSession:
    engine: ColdEngine
    n_little: int = 3
    warm_weights: Dict[str, Any] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _bg: Optional[Job] = None

    cold_weights: Dict[str, Any] = field(default_factory=dict)
    # the session's kernel maps, K_warm and K_cold, built by cold_infer
    _fns: Tuple[Dict[str, Any], Dict[str, Any]] = ({}, {})
    # resident weights already made usable on the exec stream (consume)
    _consumed: Set[Tuple[str, str]] = field(default_factory=set)

    def cold_infer(self, x) -> RunResult:
        """First inference: K_cold plan + background warm-kernel prep."""
        eng = self.engine
        res = eng.run_cold(x, n_little=self.n_little)
        # the cold run's staged tensors stay resident on the device
        self.cold_weights = dict(res.weights or {})
        self._consumed.clear()
        self._fns = (
            eng._jitted_map(eng.warm_best_choices(), eng._input_example),
            eng._jitted_map(eng.plan.choices, eng._input_example))
        self._start_background_prep()
        return res

    def _start_background_prep(self):
        """Queue K_warm − K_cold preps as one 'any'-affinity job on the
        persistent pool: idle little workers pick them up between cold
        runs, with no per-call thread creation."""
        eng = self.engine
        warm = eng.warm_best_choices()
        todo = [
            (l, wc) for l, wc, cc in
            zip(eng.layers, warm, eng.plan.choices)
            if wc.kernel != cc.kernel and l.spec.weight_shapes
        ]
        if not todo:
            self._bg = None
            return

        def prep(l, wc):
            def fn():
                kern = eng._kernel_by_name(l.spec, wc.kernel)
                raw = eng.store.read_raw(l.spec.name)
                w = stage_weights(kern.transform(raw, l.spec), eng.device)
                with self._lock:
                    self.warm_weights[l.spec.name] = (wc.kernel, w)
            return fn

        g = TaskGraph()
        for l, wc in todo:
            g.add(l.spec.name, "warm_prep", affinity="any", fn=prep(l, wc))
        rt = eng._runtime(n_little=self.n_little, work_stealing=True)
        self._bg = rt._get_pool().submit(g, name="warm-switch")

    def _resident(self, arm: str, name: str, w, stream):
        """``w`` usable on ``stream``: its staging waited for and its
        tensors marked as used there, once per resident tensor set."""
        if (arm, name) not in self._consumed:
            consume(w, stream)
            self._consumed.add((arm, name))
        return w

    def warm_infer(self, x, wait: bool = False) -> RunResult:
        """Subsequent inference: use warm kernels where prepared."""
        eng = self.engine
        if wait and self._bg is not None:
            self._bg.wait()
        t0 = time.perf_counter()
        stream = eng._stream
        y = to_device(x, eng.device, stream)
        jitted_warm, jitted_cold = self._fns

        def mark():
            if stream is None:
                return time.perf_counter() - t0
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return ev

        first = mark()
        spans = []
        for l, cold_choice in zip(eng.layers, eng.plan.choices):
            name = l.spec.name
            with self._lock:
                ready = self.warm_weights.get(name)
            if ready is not None:
                fn = jitted_warm[name]
                w = self._resident("warm", name, ready[1], stream)
            elif name in self.cold_weights:
                # unswitched layer: resident K_cold weights from the 1st run
                fn = jitted_cold[name]
                w = self._resident("cold", name, self.cold_weights[name],
                                   stream)
            else:
                kern = eng._kernel_by_name(l.spec, cold_choice.kernel)
                w = {}
                if cold_choice.use_cache:
                    w = eng.store.read_cached(name, kern.name)
                    if not w and l.spec.weight_shapes:
                        # dropped/torn cache entry: re-derive from raw
                        w = kern.transform(eng.store.read_raw(name), l.spec)
                elif l.spec.weight_shapes:
                    w = kern.transform(eng.store.read_raw(name), l.spec)
                fn = jitted_cold[name]
                w = consume(stage_weights(w, eng.device), stream)
            start = mark()
            with on_stream(stream):
                y = fn(w, y)
            spans.append((name, start, mark()))
        sync(stream)
        total = time.perf_counter() - t0
        if stream is None:
            traces = [OpTrace(n, "execute", "big", s, e) for n, s, e in spans]
        else:
            traces = [OpTrace(n, "execute", "big",
                              first.elapsed_time(s) / 1e3,
                              first.elapsed_time(e) / 1e3)
                      for n, s, e in spans]
        return RunResult(output=y, total_s=total, traces=traces)
