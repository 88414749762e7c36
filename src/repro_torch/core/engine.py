"""ColdEngine — the NNV12 workflow (Fig. 4): offline decision generation +
online cold-inference runtime.

Offline ``decide()`` (runs once when a model lands on the device):
  1. partition layers into *shape classes* (``registry.shape_class_key``) and
     profile ONE representative per (shape-class × kernel) — consulting the
     persistent shape-class ``ProfileDB`` first, so a second ``decide()`` or
     a sibling model with equivalent layers skips profiling entirely;
  2. fan the profiles out to every equivalent layer, build per-layer
     candidate lists (kernel × {raw, cached}) and Pareto-filter them once
     per shape class (Algorithm 1 line 1);
  3. run the kernel scheduler (Algorithm 1, memoized/incremental) to get
     the plan;
  4. materialize the post-transformed weight cache for chosen cached layers
     (and drop unused cache entries — storage accounting);
  5. prepare the kernel ("shader") cache per (kernel × shape-class): the
     hand-written CUDA kernels are built once (``kernels._native``) and
     each class's execute closure is bound, with meta-tensor avatars
     instead of reading + transforming real weights per layer.

Online ``run_cold()`` executes the plan with the pipelined runtime;
``run_warm()`` is the steady-state path (everything resident + built).

``device`` defaults to ``"cuda"`` and raises when no CUDA device is
visible; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.checkpoint import LayerStore, atomic_write_text
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.pipeline import PipelineJob, PipelineRuntime, RunResult
from repro_torch.executor.pool import CorePool
from repro_torch.core.profiler import CoreModel, OpProfile, ProfileDB, Profiler
from repro_torch.core.registry import (
    Kernel, LayerSpec, StatelessKernel, registry_for, shape_class_key,
    shape_class_sibling_key,
)
from repro_torch.core.scheduler import (
    Choice, LayerCandidates, Plan, pareto_filter, plan_read_depth, schedule,
)
from repro_torch.core.staging import consume, stage_weights
from repro_torch.device import (
    new_stream, on_stream, resolve_device, sync, to_device, to_numpy,
)
from repro_torch.faults import (
    CircuitBreaker, Fault, KernelFault, PlanFault, RepairLog,
)


@dataclass
class LayerDef:
    """One unit of the model graph: spec + (for stateless units) a fn."""
    spec: LayerSpec
    weights: Dict[str, np.ndarray] = field(default_factory=dict)
    fn: Optional[Callable] = None  # stateless units


class ColdEngine:
    def __init__(
        self,
        layers: List[LayerDef],
        store_dir: Path,
        *,
        core_model: CoreModel = CoreModel(),
        allow_lossy: bool = False,
        kernel_allowlist: Optional[Sequence[str]] = None,
        store_fmt: str = "bundle",
        store_verify: str = "lazy",
        share_shape_classes: bool = True,
        profile_db: Union[str, Path, ProfileDB, None] = "auto",
        profile_db_approx: bool = False,
        pool: Optional[CorePool] = None,
        io_engine: Any = "auto",
        stage_engine: Any = "auto",
        device: Any = "cuda",
    ):
        self.device = resolve_device(device)
        self._stream = new_stream(self.device)  # trace / warm / fallback
        self.layers = layers
        self.specs = [l.spec for l in layers]
        self.store = LayerStore(Path(store_dir), fmt=store_fmt,
                                verify=store_verify)
        self.core_model = core_model
        self.allow_lossy = allow_lossy
        # restrict Algorithm-1's kernel candidates by name (benchmark arms:
        # a bf16-only vs int8-only engine differ ONLY in eligible kernels).
        # The first supported registry kernel always stays eligible — it is
        # the raw-weights default used by shape tracing and fault fallback.
        self.kernel_allowlist = (set(kernel_allowlist)
                                 if kernel_allowlist is not None else None)
        self.compile_cache = CompileCache(device=self.device)
        # shape-class sharing: profile/compile one representative per class
        # and fan out. False = the legacy per-layer path (every layer keyed
        # uniquely) — kept for baselines and equivalence tests.
        self.share_shape_classes = share_shape_classes
        if profile_db == "auto":
            self.profile_db: Optional[ProfileDB] = ProfileDB(
                Path(store_dir) / "profile_db.json")
        elif profile_db is None or isinstance(profile_db, ProfileDB):
            self.profile_db = profile_db
        else:
            self.profile_db = ProfileDB(Path(profile_db))
        self.profiler_factory: Callable[..., Profiler] = Profiler
        # approximate shape-class matching: a profile DB miss may fall back
        # to a sibling class identical up to the batch dim (exact first)
        self.profile_db_approx = profile_db_approx
        self.pool = pool                  # shared persistent CorePool
        # async prep I/O: "auto" resolves to the process-wide IOEngine when
        # the store format supports extent submission; False/None forces
        # the sync reference path; an IOEngine instance is used as-is
        self._io_engine_opt = io_engine
        self._stage_engine_opt = stage_engine
        # -- fault domain (docs/robustness.md) --------------------------
        self.fault_injector = None            # chaos: threaded into runtimes
        self.retry_policy = None              # per-task retry (None=default)
        self.task_deadline_s: Optional[float] = None  # pool watchdog
        self.repairs = RepairLog(self.store.root / "repairs.jsonl")
        self.breaker = CircuitBreaker(self.store.root / "breakers.json")
        self._fallback_jitted: Dict[Tuple[str, str], Tuple[Callable, Dict]] = {}
        self._runtimes: Dict[tuple, PipelineRuntime] = {}
        self.plan: Optional[Plan] = None
        self.profiles: Dict[str, List[OpProfile]] = {}
        self._input_example: Optional[np.ndarray] = None
        self._layer_inputs: Optional[List[np.ndarray]] = None
        self._jitted_cache: Dict[tuple, Dict[str, Callable]] = {}
        self._sc_by_layer: Dict[str, str] = {}
        self._sib_by_sc: Dict[str, Optional[str]] = {}
        # shape classes whose decide() profiles came from a drifted-host
        # ProfileDB entry: sc -> representative layer index, consumed by
        # background re-profiling (reprofile_stale, the server idle tick)
        self._stale_reps: Dict[str, int] = {}
        self._transform_avatars: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # persist raw weights (the on-device model files)
        for l in layers:
            if l.weights:
                self.store.write_raw(l.spec.name, l.weights)

    # ------------------------------------------------------------------
    def _kernels_for(self, spec: LayerSpec) -> List[Kernel]:
        if spec.op_type == "stateless":
            layer = next(l for l in self.layers if l.spec.name == spec.name)
            return [StatelessKernel(layer.fn, name="fn")]
        ks = [k for k in registry_for(spec.op_type, allow_lossy=self.allow_lossy)
              if k.supports(spec)]
        if not ks:
            raise ValueError(f"no kernel for {spec}")
        if self.kernel_allowlist is not None:
            ks = [k for i, k in enumerate(ks)
                  if i == 0 or k.name in self.kernel_allowlist]
        return ks

    def _profiler(self) -> Profiler:
        return self.profiler_factory(self.store, device=self.device)

    def _trace_shapes(self, x: np.ndarray) -> List[np.ndarray]:
        """Propagate an example input through default kernels to get each
        layer's input example (needed to profile per-layer execution)."""
        xs = []
        y = to_device(x, self.device, self._stream)
        with on_stream(self._stream):
            for l in self.layers:
                xs.append(to_numpy(y))
                kern = self._kernels_for(l.spec)[0]
                w = {k: bf16.to_tensor(np.array(v)).to(self.device)
                     for k, v in l.weights.items()}
                y = kern.execute(w, y, l.spec)
            self._output_example = to_numpy(y)
        return xs

    # ------------------------------------------------------------------
    def _shape_class_for(self, l: LayerDef, xin: np.ndarray) -> str:
        """Profile/compile-sharing identity of a layer. With sharing off the
        layer name is folded in, making every class a singleton (the legacy
        per-layer path)."""
        xin = np.asarray(xin)
        kw = dict(
            input_shape=tuple(xin.shape), input_dtype=bf16.dtype_name(xin),
            weight_dtypes={k: bf16.dtype_name(np.asarray(v))
                           for k, v in l.weights.items()} or None,
        )
        key = shape_class_key(l.spec, **kw)
        if not self.share_shape_classes:
            key = f"{key}:{l.spec.name}"
        else:
            # batch-agnostic sibling identity for approximate ProfileDB
            # fan-out (legacy per-layer classes never share, so no sibling)
            self._sib_by_sc[key] = shape_class_sibling_key(l.spec, **kw)
        return key

    def _options_from_profiles(
        self, plist: List[OpProfile], spec: LayerSpec,
    ) -> List[Tuple[Choice, float, float, float]]:
        """Candidate (choice, prep_little, prep_big, exec) tuples from one
        shape class's profiles, Pareto-filtered once and shared by every
        member layer."""
        cm = self.core_model
        options = []
        for p in plist:
            for use_cache in ((False, True) if spec.weight_shapes else (False,)):
                # big-core prep = read(+transform)+stage; reads are
                # metadata-cheap with mmap bundles, staging carries the
                # actual byte movement — the split the scheduler needs
                prep_big = p.prep_s(use_cache)
                # little-core factors per op kind (Fig. 6 affinity),
                # reads scaled by the measured co-read interference
                rd = cm.little_read * self.io_interference
                stage = p.stage_s * cm.little_stage
                if use_cache:
                    prep_little = p.read_cached_s * rd + stage
                else:
                    prep_little = (p.read_raw_s * rd
                                   + p.transform_s * cm.little_transform
                                   + stage)
                options.append(
                    (Choice(p.kernel, use_cache), prep_little, prep_big,
                     p.exec_s))
        filtered = pareto_filter([(c, pl, ex) for c, pl, pb, ex in options])
        keep_keys = {id(c[0]) for c in filtered}
        return [o for o in options if id(o[0]) in keep_keys]

    # -- degradation ladder: the plan itself --------------------------------
    def fallback_plan(self, n_little: int = 3) -> Plan:
        """Default heuristic plan — the ladder's last rung when no decision
        exists and none can be recovered. Reference kernel (registry head)
        per layer, no weight cache, first weighted layer prepped on the big
        cores, the rest round-robin across the little lanes. Correct by
        construction; only the latency is degraded."""
        choices = [Choice(self._kernels_for(l.spec)[0].name, False)
                   for l in self.layers]
        weighted = [i for i, l in enumerate(self.layers)
                    if l.spec.weight_shapes]
        if n_little <= 0:
            return Plan(choices, weighted, [], 0.0)
        rest = weighted[1:]
        return Plan(choices, weighted[:1],
                    [rest[j::n_little] for j in range(n_little)], 0.0)

    def ensure_plan(self, x_example: np.ndarray, *,
                    n_little: int = 3) -> Plan:
        """A usable plan, never an exception: in-memory plan → ``plan.json``
        reload (validated) → :meth:`fallback_plan`. A cold request on a
        fresh process must not fail because the offline decision is missing
        or corrupt — it proceeds degraded and journals the repair."""
        if self._input_example is None:
            self._input_example = x_example
        if self.plan is not None:
            return self.plan
        plan_path = self.store.root / "plan.json"
        try:
            d = json.loads(plan_path.read_text())["plan"]
            plan = Plan.from_dict(d)
            self._check_plan(plan, "plan.json")
            self.plan = plan
            return plan
        except FileNotFoundError:
            pass
        except Exception as e:
            self.repairs.record("plan_fallback",
                                reason=f"plan.json unusable: {e}")
        self.plan = self.fallback_plan(n_little)
        return self.plan

    def _check_plan(self, plan: Plan, what: str) -> None:
        if len(plan.choices) != len(self.layers):
            raise PlanFault(
                f"{what} has {len(plan.choices)} choices for "
                f"{len(self.layers)} layers")
        for l, c in zip(self.layers, plan.choices):
            if all(k.name != c.kernel
                   for k in self._kernels_for(l.spec)):
                raise PlanFault(
                    f"{what} picks unknown kernel {c.kernel!r} "
                    f"for layer {l.spec.name!r}", layer=l.spec.name,
                    kernel=c.kernel)

    def set_plan(self, plan: Plan) -> None:
        """Install an externally chosen plan (a pinned plan, as tests and
        the smoke run use to force given kernels), validated like a
        reloaded ``plan.json``. Cached choices need entries materialized
        by ``decide()``; a missing one is recomputed and journaled."""
        self._check_plan(plan, "plan")
        self.plan = plan
        self._runtimes.clear()

    def decide(
        self, x_example: np.ndarray, *, n_little: int = 3,
        force_reprofile: bool = False, calibrate_interference: bool = True,
    ) -> Dict[str, Any]:
        """Offline decision stage. Returns stats incl. generation time.

        Degradation ladder: a typed ``Fault`` raised while profiling or
        scheduling (sick store, poisoned ProfileDB, ...) demotes the
        decision to :meth:`fallback_plan` instead of failing — the stats
        carry ``degraded=True`` and the repair is journaled."""
        if force_reprofile:
            # operator lever: a forced re-decide also gives kernels demoted
            # by the runtime circuit breakers another chance
            self.breaker.reset()
            self.breaker.save()
        t0 = time.perf_counter()
        try:
            return self._decide_core(
                x_example, n_little=n_little,
                force_reprofile=force_reprofile,
                calibrate_interference=calibrate_interference, t0=t0)
        except Fault as e:
            self.repairs.record("decide_degraded", reason=repr(e))
            self.plan = self.fallback_plan(n_little)
            self._runtimes.clear()
            stats = {"degraded": True, "error": str(e) or repr(e),
                     "plan_generation_s": time.perf_counter() - t0,
                     "est_makespan_s": 0.0}
            try:
                atomic_write_text(
                    self.store.root / "plan.json", json.dumps(
                        {"plan": self.plan.to_dict(), "stats": stats},
                        indent=1))
            except OSError:
                pass
            return stats

    def _decide_core(
        self, x_example: np.ndarray, *, n_little: int,
        force_reprofile: bool, calibrate_interference: bool, t0: float,
    ) -> Dict[str, Any]:
        self._input_example = x_example
        layer_inputs = self._layer_inputs = self._trace_shapes(x_example)
        # §3.2: co-running preps share disk bandwidth — measure the real
        # per-op slowdown with n_little concurrent readers and fold it into
        # the little-core prep costs the scheduler optimizes against.
        self.io_interference = 1.0
        if calibrate_interference and n_little > 1:
            from repro_torch.core.profiler import measure_read_interference

            self.io_interference = measure_read_interference(
                self.store, [l.spec.name for l in self.layers], n_little)

        # partition into shape classes; profile one representative per
        # (class × kernel), consulting the persistent profile DB first
        self._sc_by_layer = {}
        groups: Dict[str, List[int]] = {}
        for i, (l, xin) in enumerate(zip(self.layers, layer_inputs)):
            sc = self._shape_class_for(l, xin)
            self._sc_by_layer[l.spec.name] = sc
            groups.setdefault(sc, []).append(i)

        db = self.profile_db
        db_hits = 0
        prof = self._profiler()
        sc_profiles: Dict[str, List[OpProfile]] = {}
        try:
            for sc, idxs in groups.items():
                rep, xin = self.layers[idxs[0]], layer_inputs[idxs[0]]
                plist: List[OpProfile] = []
                sib = self._sib_by_sc.get(sc)
                for kern in self._kernels_for(rep.spec):
                    p = None
                    if db is not None and not force_reprofile:
                        p = db.get(sc, kern.name, sibling_key=sib,
                                   approx=self.profile_db_approx)
                        if p is not None:
                            db_hits += 1
                    if p is None:
                        p = prof.profile(rep.spec, kern, xin)
                        if db is not None:
                            db.put(sc, kern.name, p, sibling_key=sib)
                    plist.append(p)
                    if p.transformed_avatars is not None:
                        self._transform_avatars[(sc, kern.name)] = \
                            p.transformed_avatars
                sc_profiles[sc] = plist
        finally:
            prof.close()
        if db is not None:
            db.save()
        profile_calls = prof.calls
        # host-fingerprint drift: classes resolved from a stale (drifted)
        # DB entry keep serving — record their representatives so the idle
        # tick can re-measure off the cold path (reprofile_stale)
        if db is not None and db.stale:
            for sc, idxs in groups.items():
                if any((sc, k) in db.stale for k in
                       (kern.name for kern in
                        self._kernels_for(self.layers[idxs[0]].spec))):
                    self._stale_reps[sc] = idxs[0]

        # fan profiles out to every member layer; candidate sweeps (incl.
        # the Pareto filter) collapse to one per shape class
        self.profiles = {}
        cands: List[Optional[LayerCandidates]] = [None] * len(self.layers)
        open_keys = set(self.breaker.open_keys())
        for sc, idxs in groups.items():
            plist = sc_profiles[sc]
            spec0 = self.layers[idxs[0]].spec
            options = self._options_from_profiles(plist, spec0)
            for i in idxs:
                name = self.layers[i].spec.name
                self.profiles[name] = [replace(p, layer=name) for p in plist]
                opts = options
                if open_keys:
                    # kernels demoted at runtime (open circuit breaker for
                    # this shape class or layer) are excluded from re-decide
                    # until force_reprofile resets them; the registry-head
                    # reference kernel is always kept as a floor
                    healthy = [
                        p.kernel for p in plist
                        if CircuitBreaker.key(p.kernel, sc) not in open_keys
                        and CircuitBreaker.key(p.kernel, name) not in open_keys
                    ] or [plist[0].kernel]
                    opts = [o for o in options if o[0].kernel in healthy]
                    if not opts:  # every healthy kernel was Pareto-dominated
                        opts = self._options_from_profiles(
                            [p for p in plist if p.kernel in healthy], spec0)
                cands[i] = LayerCandidates(layer=name, options=opts)

        self.plan = schedule(cands, n_little)
        # I/O queue depth for the async engine: planned from the same
        # profiled costs the kernel scheduler just optimized — enough
        # parallel reads to hide the read column behind transform+stage,
        # clamped so a lane never floods the disk past the measured
        # interference regime. Persisted in plan.json with the rest of the
        # decision (graph.compile_plan stamps it on every read task).
        cm = self.core_model
        read_costs, other_costs = [], []
        for l, c in zip(self.layers, self.plan.choices):
            p = next((pp for pp in sc_profiles[self._sc_by_layer[l.spec.name]]
                      if pp.kernel == c.kernel), None)
            if p is None:
                continue
            rd = p.read_cached_s if c.use_cache else p.read_raw_s
            read_costs.append(rd * cm.little_read)
            xf = 0.0 if c.use_cache else p.transform_s * cm.little_transform
            other_costs.append(xf + p.stage_s * cm.little_stage)
        self.plan.read_depth = plan_read_depth(
            read_costs, other_costs, io_interference=self.io_interference)
        self._runtimes.clear()     # cached runtimes are plan-bound
        # materialize/drop the weight cache per the plan; entries already
        # materialized by a previous decide() from the SAME raw weights
        # (fingerprint sidecar) are kept as-is, so a warm-DB decide performs
        # zero transforms — but an updated checkpoint invalidates them
        fp_path = self.store.root / "cache_fingerprints.json"
        try:
            fps: Dict[str, Dict[str, str]] = json.loads(fp_path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            fps = {}
        for l, choice in zip(self.layers, self.plan.choices):
            if not l.spec.weight_shapes:
                continue
            kern = self._kernel_by_name(l.spec, choice.kernel)
            for k2 in self._kernels_for(l.spec):
                if k2.name != kern.name or not choice.use_cache:
                    self.store.drop_cached(l.spec.name, k2.name)
            if not choice.use_cache:
                fps.pop(l.spec.name, None)
                continue
            fp = self._raw_fingerprint(l)
            fresh = (not force_reprofile and fp != ""
                     and self.store.has_cached(l.spec.name, kern.name)
                     and fps.get(l.spec.name, {}).get(kern.name) == fp)
            if not fresh:
                raw = self.store.read_raw(l.spec.name)
                self.store.write_cached(l.spec.name, kern.name,
                                        kern.transform(raw, l.spec))
            fps[l.spec.name] = {kern.name: fp}
        # durable sidecar commit: a crash mid-write must not leave a torn
        # fingerprint file silently validating stale cache entries
        atomic_write_text(fp_path, json.dumps(fps, indent=1), durable=True)
        # post-materialization maintenance: dropped/superseded cache entries
        # leave dead extents in a super-bundle container; compact them out
        maintenance = self.store.maintain()
        # a fresh decision answers any pending re-decide requests left by
        # runtime kernel demotions (_fallback_execute)
        rp = self.store.root / "replan_pending.json"
        replan_cleared: List[str] = []
        try:
            replan_cleared = sorted(json.loads(rp.read_text()))
            rp.unlink()
        except (FileNotFoundError, json.JSONDecodeError, OSError, ValueError):
            pass
        gen_s = time.perf_counter() - t0
        # read-vs-stage split of the chosen plan's big-core prep costs
        split = {"read_s": 0.0, "transform_s": 0.0, "stage_s": 0.0}
        for l, c in zip(self.layers, self.plan.choices):
            p = next(pp for pp in self.profiles[l.spec.name]
                     if pp.kernel == c.kernel)
            if c.use_cache:
                split["read_s"] += p.read_cached_s
            else:
                split["read_s"] += p.read_raw_s
                split["transform_s"] += p.transform_s
            split["stage_s"] += p.stage_s
        # planned cold-read bytes of the chosen plan: the FOLDED extent
        # bytes each choice will pull off disk (quantized entries count
        # their int8/int4 payload, not the dequantized footprint)
        cold = {"raw_bytes": 0, "cached_bytes": 0,
                "by_kernel": {}}  # type: Dict[str, Any]
        for l, c in zip(self.layers, self.plan.choices):
            if not l.spec.weight_shapes:
                continue
            if c.use_cache:
                nb = self.store.cached_bytes(l.spec.name, c.kernel)
                cold["cached_bytes"] += nb
            else:
                nb = self.store.raw_bytes(l.spec.name)
                cold["raw_bytes"] += nb
            cold["by_kernel"][c.kernel] = cold["by_kernel"].get(c.kernel,
                                                                0) + nb
        stats = {
            "plan_generation_s": gen_s,
            "est_makespan_s": self.plan.est_makespan,
            "planned_cold_read_bytes": cold,
            "io_interference": self.io_interference,
            "read_depth": self.plan.read_depth,
            "cache_bytes": self.store.cache_bytes(),
            "model_bytes": self.store.model_bytes(),
            "prep_split": split,
            "shape_classes": len(groups),
            "profile_calls": profile_calls,
            "profile_db_hits": db_hits,
            "profile_db_approx_hits": (
                db.stats["approx_hits"] if db is not None else 0),
            "profile_db_stale_hits": (
                db.stats.get("stale_hits", 0) if db is not None else 0),
            "store_maintenance": maintenance,
            "replan_cleared": replan_cleared,
            "choices": {l.spec.name: (c.kernel, c.use_cache)
                        for l, c in zip(self.layers, self.plan.choices)},
        }
        atomic_write_text(self.store.root / "plan.json", json.dumps(
            {"plan": self.plan.to_dict(), "stats": stats}, indent=1))
        return stats

    def _kernel_by_name(self, spec: LayerSpec, name: str) -> Kernel:
        return next(k for k in self._kernels_for(spec) if k.name == name)

    # -- background re-profiling on host-fingerprint drift -------------------
    def reprofile_stale(self, max_classes: Optional[int] = None) -> int:
        """Re-measure shape classes whose last ``decide()`` was served by a
        drifted-host ProfileDB entry. Runs on the server's IDLE tick — never
        on the cold path: the stale estimates keep serving until the fresh
        measurements land in the DB (picked up by the next ``decide()``).
        Returns the number of classes refreshed."""
        db = self.profile_db
        if db is None or not self._stale_reps or self._layer_inputs is None:
            return 0
        done = 0
        prof = self._profiler()
        try:
            for sc, rep_idx in list(self._stale_reps.items()):
                if max_classes is not None and done >= max_classes:
                    break
                rep = self.layers[rep_idx]
                xin = self._layer_inputs[rep_idx]
                sib = self._sib_by_sc.get(sc)
                for kern in self._kernels_for(rep.spec):
                    if (sc, kern.name) not in db.stale:
                        continue
                    p = prof.profile(rep.spec, kern, xin)
                    db.put(sc, kern.name, p, sibling_key=sib)
                del self._stale_reps[sc]
                done += 1
                self.repairs.record(
                    "reprofile_drift", layer=rep.spec.name,
                    shape_class=sc[:40],
                    drifted_from=getattr(db, "drifted_from", None))
        finally:
            prof.close()
        if done:
            db.save()
        return done

    def _raw_fingerprint(self, l: LayerDef) -> str:
        """Content hash of a layer's raw weights — guards cached transformed
        entries against checkpoint updates (a stale entry would silently
        change outputs)."""
        import hashlib

        if not l.weights:
            return ""  # content unknown: never matches -> always rewrite
        h = hashlib.sha1()
        for k in sorted(l.weights):
            h.update(k.encode())
            h.update(np.ascontiguousarray(l.weights[k]).tobytes())
        return h.hexdigest()[:20]

    # -- degradation ladder: the execute rung -------------------------------
    def _mark_replan(self, layer: str) -> None:
        """Persist a re-decide request: the next ``decide()`` on this store
        sees and clears it (``stats["replan_cleared"]``)."""
        rp = self.store.root / "replan_pending.json"
        try:
            pending = set(json.loads(rp.read_text()))
        except (FileNotFoundError, json.JSONDecodeError, ValueError):
            pending = set()
        pending.add(layer)
        try:
            atomic_write_text(rp, json.dumps(sorted(pending)))
        except OSError:
            pass  # advisory marker; losing it only delays the re-decide

    def _fallback_execute(self, layer: str, x, exc,
                          chosen: Optional[str] = None):
        """A layer's chosen kernel faulted at execute (or its circuit
        breaker is already open, ``exc is None``): demote the
        (kernel, shape-class) pair, journal the repair, mark the plan for
        re-decide, and finish the request on the reference kernel. The
        request degrades in latency, never in correctness — the reference
        kernel is the zero-transform registry head the oracles pin down."""
        l = next(ld for ld in self.layers if ld.spec.name == layer)
        if chosen is None and self.plan is not None:
            idx = next(i for i, ld in enumerate(self.layers)
                       if ld.spec.name == layer)
            chosen = self.plan.choices[idx].kernel
        sc = self._sc_by_layer.get(layer) or layer
        if exc is not None and chosen is not None:
            key = CircuitBreaker.key(chosen, sc)
            self.breaker.record_failure(key, reason=repr(exc))
            self.breaker.save()
            self.repairs.record("kernel_demoted", layer=layer, kernel=chosen,
                                shape_class=sc, reason=repr(exc))
            self._mark_replan(layer)
        ref = next(
            (k for k in self._kernels_for(l.spec)
             if k.name != chosen
             and self.breaker.allow(CircuitBreaker.key(k.name, sc))),
            None)
        if ref is None:
            raise KernelFault(
                f"no healthy fallback kernel for layer {layer!r}",
                layer=layer, kernel=chosen) from exc
        ent = self._fallback_jitted.get((layer, ref.name))
        if ent is None:
            w = {}
            if l.spec.weight_shapes:
                w = stage_weights(
                    ref.transform(self.store.read_raw(layer), l.spec),
                    self.device)
            fn = (lambda kern, spec: lambda w_, x_:
                  kern.execute(w_, x_, spec))(ref, l.spec)
            ent = self._fallback_jitted[(layer, ref.name)] = (fn, w)
        fn, w = ent
        # runs on the caller's current stream (the runtime's exec stream)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        y = fn(consume(w, stream), to_device(x, self.device))
        sync(stream)
        return y

    # ------------------------------------------------------------------
    def _avatar_dtype(self, name: str) -> torch.dtype:
        return bf16.to_tensor(np.empty(0, bf16.np_dtype(name))).dtype

    def _jitted_map(self, choices: List[Choice], x_example) -> Dict[str, Callable]:
        """Execute callables per layer (through the kernel cache, keyed by
        shape class — equivalent layers share one entry); memoized per
        kernel-choice tuple. Cache examples are meta-tensor avatars: no
        layer's real weights are read or transformed here. The
        transformed shapes come from profiling (or the profile DB); a layer
        whose profiles never ran falls back to one real transform per
        (shape-class, kernel)."""
        key = tuple(c.kernel for c in choices)
        if key in self._jitted_cache:
            return self._jitted_cache[key]
        jitted = {}
        if self._layer_inputs is None:
            self._layer_inputs = self._trace_shapes(x_example)
        layer_inputs = self._layer_inputs
        for l, ch, xin in zip(self.layers, choices, layer_inputs):
            kern = self._kernel_by_name(l.spec, ch.kernel)
            sc = self._sc_by_layer.get(l.spec.name)
            if sc is None:
                sc = self._sc_by_layer[l.spec.name] = \
                    self._shape_class_for(l, xin)
            if l.spec.weight_shapes:
                avatars = self._transform_avatars.get((sc, kern.name))
                if avatars is None:
                    from repro_torch.core.profiler import avatars_of

                    raw = self.store.read_raw(l.spec.name)
                    avatars = avatars_of(kern.transform(raw, l.spec))
                    self._transform_avatars[(sc, kern.name)] = avatars
                w_ex = {k2: torch.empty(tuple(shape),
                                        dtype=self._avatar_dtype(dt),
                                        device="meta")
                        for k2, (shape, dt) in avatars.items()}
            else:
                w_ex = {}
            xin = np.asarray(xin)
            x_ex = torch.empty(tuple(xin.shape),
                               dtype=self._avatar_dtype(bf16.dtype_name(xin)),
                               device="meta")
            fn = (lambda kern, spec: lambda w, x: kern.execute(w, x, spec))(kern, l.spec)
            compiled = self.compile_cache.get(kern.name, l.spec, fn, w_ex,
                                              x_ex, shape_class=sc)
            jitted[l.spec.name] = compiled
        self._jitted_cache[key] = jitted
        return jitted

    def _resolve_io_engines(self) -> Tuple[Optional[Any], Optional[Any]]:
        """Resolve the ``io_engine``/``stage_engine`` knobs to instances.

        ``"auto"`` binds the process-wide engines lazily — only when a
        runtime is actually built, and only when the store format supports
        extent submission (legacy npy stays on the sync reference path).
        ``False``/``None`` disables; instances pass through."""
        io_eng = self._io_engine_opt
        if io_eng == "auto":
            io_eng = None
            if getattr(self.store, "supports_async", False):
                from repro_torch.ioengine import get_io_engine

                io_eng = get_io_engine()
        elif not io_eng:
            io_eng = None
        st_eng = self._stage_engine_opt
        if st_eng == "auto":
            st_eng = None
            if io_eng is not None:
                from repro_torch.ioengine import get_stage_engine

                st_eng = get_stage_engine()
        elif not st_eng:
            st_eng = None
        return io_eng, st_eng

    def make_runtime(self, *, n_little: int = 3, plan: Optional[Plan] = None,
                     work_stealing: bool = True) -> PipelineRuntime:
        plan = plan or self.plan
        assert plan is not None, "call decide() first"
        kernels = {l.spec.name: self._kernel_by_name(l.spec, c.kernel)
                   for l, c in zip(self.layers, plan.choices)}
        use_cache = {l.spec.name: c.use_cache
                     for l, c in zip(self.layers, plan.choices)}
        jitted = self._jitted_map(plan.choices, self._input_example)
        # profiled per-layer LITTLE-core prep costs (same factors the
        # simulator uses) let the runtime's work stealer pick the donor by
        # remaining prep time, matching the plan's makespan model
        cm = self.core_model
        interference = getattr(self, "io_interference", 1.0)
        prep_costs = {}
        for l, c in zip(self.layers, plan.choices):
            p = next((pp for pp in self.profiles.get(l.spec.name, [])
                      if pp.kernel == c.kernel), None)
            if p is not None:
                rd = cm.little_read * interference
                stage = p.stage_s * cm.little_stage
                if c.use_cache:
                    prep_costs[l.spec.name] = p.read_cached_s * rd + stage
                else:
                    prep_costs[l.spec.name] = (
                        p.read_raw_s * rd
                        + p.transform_s * cm.little_transform + stage)
        # fault-domain plumbing: the runtime's execute tasks consult the
        # circuit breakers and demote to _fallback_execute; repairs and
        # injected chaos flow through the engine-owned log/injector
        choice_by_layer = {l.spec.name: c
                           for l, c in zip(self.layers, plan.choices)}

        def exec_allowed(name: str) -> bool:
            sc = self._sc_by_layer.get(name) or name
            return self.breaker.allow(
                CircuitBreaker.key(choice_by_layer[name].kernel, sc))

        def fallback_exec(name: str, x, exc):
            return self._fallback_execute(
                name, x, exc, chosen=choice_by_layer[name].kernel)

        io_eng, st_eng = self._resolve_io_engines()
        return PipelineRuntime(
            self.specs, kernels, use_cache, self.store, jitted,
            n_little=n_little, work_stealing=work_stealing,
            prep_costs=prep_costs or None, pool=self.pool,
            retry=self.retry_policy, deadline_s=self.task_deadline_s,
            fault_injector=self.fault_injector, repair_log=self.repairs,
            fallback_exec=fallback_exec, exec_allowed=exec_allowed,
            io_engine=io_eng, stage_engine=st_eng, device=self.device,
        )

    def _runtime(self, *, n_little: int, work_stealing: bool) -> PipelineRuntime:
        """The steady-path runtime: built once per (plan, n_little,
        stealing) and reused — no per-run construction, and the underlying
        persistent CorePool means no per-run threads either."""
        key = (n_little, work_stealing)
        rt = self._runtimes.get(key)
        if rt is None:
            rt = self._runtimes[key] = self.make_runtime(
                n_little=n_little, work_stealing=work_stealing)
        return rt

    def submit_cold(self, x, *, n_little: int = 3, work_stealing: bool = True,
                    graph_hook=None,
                    deadline_s: Optional[float] = None) -> PipelineJob:
        """Non-blocking cold run: compile the plan's task graph and enqueue
        it on the shared pool (the ColdServer's admission path).
        ``deadline_s`` bounds the whole run end-to-end (typed
        ``DeadlineExceeded`` from the pool watchdog once blown)."""
        rt = self._runtime(n_little=n_little, work_stealing=work_stealing)
        return rt.submit(x, self.plan, graph_hook=graph_hook,
                         job_deadline_s=deadline_s)

    def run_cold(self, x, *, n_little: int = 3, mode: str = "nnv12") -> RunResult:
        """mode: nnv12 (full) | sequential (ncnn-like baseline) |
        nnv12_nosteal"""
        if mode == "sequential":
            rt = self.make_runtime(n_little=n_little)
            # baseline: warm-best kernels, no cache, fully sequential
            warm_best = self.warm_best_choices()
            # the ncnn-like baseline models an engine WITHOUT a checksum
            # layer: land the store's one-off lazy CRC audit here, not
            # inside the baseline's timed traces
            self.store.warm_verify(
                l.spec.name for l in self.layers if l.spec.weight_shapes)
            kernels = {l.spec.name: self._kernel_by_name(l.spec, c.kernel)
                       for l, c in zip(self.layers, warm_best)}
            rt2 = PipelineRuntime(
                self.specs, kernels, {n: False for n in rt.use_cache},
                self.store, self._jitted_map(warm_best, self._input_example),
                n_little=0, device=self.device)
            return rt2.run_sequential(x)
        return self.submit_cold(
            x, n_little=n_little,
            work_stealing=(mode != "nnv12_nosteal")).result()

    def run_warm(self, x, repeats: int = 3) -> float:
        """Steady-state latency with warm-best kernels, weights resident."""
        choices = self.warm_best_choices()
        jitted = self._jitted_map(choices, self._input_example)
        weights = {}
        for l, ch in zip(self.layers, choices):
            kern = self._kernel_by_name(l.spec, ch.kernel)
            raw = self.store.read_raw(l.spec.name) if l.spec.weight_shapes else {}
            w = kern.transform(raw, l.spec) if l.spec.weight_shapes else {}
            # stage_weights, not torch.from_numpy: identity transforms hand
            # back mmap views whose aliasing would leave disk I/O in execute
            weights[l.spec.name] = consume(stage_weights(w, self.device),
                                           self._stream)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            y = to_device(x, self.device, self._stream)
            with on_stream(self._stream):
                for l in self.layers:
                    y = jitted[l.spec.name](weights[l.spec.name], y)
            sync(self._stream)
            best = min(best, time.perf_counter() - t0)
        return best

    def warm_best_choices(self) -> List[Choice]:
        """Per-layer kernel with the fastest *execution* (ncnn's policy)."""
        out = []
        for l in self.layers:
            ps = self.profiles.get(l.spec.name)
            assert ps, "decide() must run first"
            best = min(ps, key=lambda p: p.exec_s)
            out.append(Choice(best.kernel, False))
        return out
