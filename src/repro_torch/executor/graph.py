"""Typed task graphs — one representation shared by the plan and the runtime.

A scheduling ``Plan`` (kernel/cache choices + prep placement) compiles into
an explicit DAG of typed tasks:

  * per weighted layer, a *prep chain* ``read [→ transform] → stage`` whose
    tasks carry the lane (little core index) or big-core affinity the plan
    assigned, plus the layer's estimated prep cost (the work stealer's
    donor metric);
  * per layer, an ``execute`` task on the big cores, depending on the
    layer's ``stage`` and the previous layer's ``execute`` (the exec chain);
  * optionally, per weighted layer, a dep-free ``fetch_remote`` task
    (affinity ``any``) that races the local prep chain by streaming the
    layer's staged weights from a sibling worker — first finisher wins,
    the loser is cancelled (``CorePool.cancel_tasks``).  ``fetch_remote``
    is deliberately NOT a ``PREP_KINDS`` member: prep accounting
    (admission slots, preps-done, steal metrics) describes the *local*
    chain, and a fetch win retires that chain through cancellation;
  * arbitrary extra tasks (e.g. the LLM bridge's decode-path ``pack`` ops)
    can be appended with explicit deps before submission.

``simulate_graph`` maps a compiled graph back onto the scheduler's
event-driven ``simulate`` — the plan's makespan model and the executor run
the *same* structure, which the equivalence tests pin down.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import Plan, simulate

# task kinds that count as "preparation" (admission control + accounting)
PREP_KINDS = ("read", "transform", "stage")

#: affinity tags: ``big`` (big-core workers), ``little`` (the lane's little
#: worker, stealable), ``any`` (whoever idles first — deferred staging,
#: background packing)
AFFINITIES = ("big", "little", "any")


@dataclass
class OpTrace:
    layer: str
    kind: str
    core: str
    start: float
    end: float


@dataclass
class Task:
    tid: int
    layer: str
    kind: str                       # read | transform | stage | execute | ...
    affinity: str                   # big | little | any
    lane: Optional[int] = None      # little lane for affinity == "little"
    deps: Tuple[int, ...] = ()
    cost: float = 0.0               # est. seconds; chain head carries the
                                    # layer's full prep cost (steal metric)
    fn: Optional[Callable[[], None]] = None
    deadline_s: Optional[float] = None  # per-task deadline; None = inherit
                                        # the job-level default (pool watchdog)
    depth: int = 1                  # read tasks: planned I/O queue depth —
                                    # how many lane successors to submit
                                    # alongside this read (Plan.read_depth)


class TaskGraph:
    def __init__(self):
        self.tasks: List[Task] = []
        self._index: Dict[Tuple[str, str], int] = {}

    def add(self, layer: str, kind: str, *, affinity: str,
            lane: Optional[int] = None, deps: Sequence[int] = (),
            cost: float = 0.0, fn: Optional[Callable] = None) -> Task:
        assert affinity in AFFINITIES, affinity
        if affinity == "little" and lane is None:
            # a laneless little task would sit in a queue no worker drains
            # and no steal reaches — the job would hang forever
            raise ValueError(
                f"little-affinity task {layer}/{kind} needs a lane")
        t = Task(tid=len(self.tasks), layer=layer, kind=kind,
                 affinity=affinity, lane=lane, deps=tuple(deps), cost=cost,
                 fn=fn)
        self.tasks.append(t)
        self._index[(layer, kind)] = t.tid
        return t

    def task(self, layer: str, kind: str) -> Optional[Task]:
        tid = self._index.get((layer, kind))
        return None if tid is None else self.tasks[tid]

    def lanes(self) -> List[int]:
        return sorted({t.lane for t in self.tasks
                       if t.affinity == "little" and t.lane is not None})

    def validate(self) -> None:
        """Deps must point backwards (the builder emits topological order)."""
        for t in self.tasks:
            for d in t.deps:
                if not (0 <= d < t.tid):
                    raise ValueError(
                        f"task {t.tid} ({t.layer}/{t.kind}) has forward or "
                        f"dangling dep {d}")

    # -- plan-structure recovery (simulation / introspection) ---------------
    def exec_order(self) -> List[str]:
        return [t.layer for t in self.tasks if t.kind == "execute"]

    def prep_chains(self) -> Dict[str, List[Task]]:
        """Per-layer prep chain (read/transform/stage tasks, tid order)."""
        chains: Dict[str, List[Task]] = {}
        for t in self.tasks:
            if t.kind in PREP_KINDS:
                chains.setdefault(t.layer, []).append(t)
        return chains

    def big_prep_layers(self) -> List[str]:
        seen, out = set(), []
        for t in self.tasks:
            if t.kind in PREP_KINDS and t.affinity == "big" \
                    and t.layer not in seen:
                seen.add(t.layer)
                out.append(t.layer)
        return out

    def lane_queues(self) -> Dict[int, List[str]]:
        queues: Dict[int, List[str]] = {}
        for t in self.tasks:
            if t.kind in PREP_KINDS and t.affinity == "little":
                q = queues.setdefault(t.lane, [])
                if t.layer not in q:
                    q.append(t.layer)
        return queues


def compile_plan(
    order: Sequence[str],
    plan: Plan,
    *,
    weighted: Dict[str, bool],
    use_cache: Dict[str, bool],
    prep_costs: Optional[Dict[str, float]] = None,
    stage_in_prep: bool = True,
    deferred_stage_affinity: str = "any",
    read_depth: Optional[int] = None,
    fetch_layers: Optional[Sequence[str]] = None,
) -> TaskGraph:
    """Compile a scheduling ``Plan`` into a typed task graph.

    ``weighted`` marks layers with on-disk weights (weightless/stateless
    units get only an ``execute`` task, like the runtime always treated
    them). With ``stage_in_prep`` the ``stage`` op is the tail of the prep
    chain on the same core; otherwise it is emitted with
    ``deferred_stage_affinity`` (``any`` = prefetch: whoever idles first,
    including the big core right before the layer's execute; ``big`` =
    strictly inline on the big cores).

    ``read_depth`` (default: the plan's) stamps every read task with the
    I/O queue depth the async engine should sustain — the runtime's read
    op submits that many lane successors before reaping its own layer.

    ``fetch_layers`` names weighted layers for which a ``fetch_remote``
    race task is also emitted: dep-free, affinity ``any``, placed FIRST
    (lowest tids) so idle workers start the peer stream before local
    chains queue up.  The execute chain keeps its dep on ``stage`` only —
    a fetch win satisfies it by cancelling the stage task, a fetch loss
    or fault leaves the local chain authoritative."""
    prep_costs = prep_costs or {}
    depth = max(1, int(plan.read_depth if read_depth is None else read_depth))
    g = TaskGraph()
    for name in (fetch_layers or ()):
        if weighted.get(name, False):
            g.add(name, "fetch_remote", affinity="any")
    placement: Dict[str, Tuple[str, Optional[int]]] = {}
    for i in plan.big_prep:
        placement[order[i]] = ("big", None)
    for j, q in enumerate(plan.little_queues):
        for i in q:
            placement[order[i]] = ("little", j)

    def emit_chain(name: str):
        aff, lane = placement.get(name, ("big", None))
        cost = float(prep_costs.get(name, 0.0))
        head = g.add(name, "read", affinity=aff, lane=lane, cost=cost)
        head.depth = depth
        prev = head
        if not use_cache.get(name, False):
            prev = g.add(name, "transform", affinity=aff, lane=lane,
                         deps=(prev.tid,))
        if stage_in_prep:
            g.add(name, "stage", affinity=aff, lane=lane, deps=(prev.tid,))
        else:
            g.add(name, "stage", affinity=deferred_stage_affinity,
                  lane=None, deps=(prev.tid,))

    # big-core preps first (tid order is the big worker's priority order:
    # the plan's big preps run before the exec chain, as Algorithm 1 lays
    # them out), then the little lanes in queue order, then the exec chain.
    for i in plan.big_prep:
        if weighted.get(order[i], False):
            emit_chain(order[i])
    for q in plan.little_queues:
        for i in q:
            if weighted.get(order[i], False):
                emit_chain(order[i])
    # any weighted layer the plan did not place (defensive): big cores
    for name in order:
        if weighted.get(name, False) and g.task(name, "read") is None:
            placement.setdefault(name, ("big", None))
            emit_chain(name)

    prev_exec: Optional[Task] = None
    for name in order:
        deps = []
        st = g.task(name, "stage")
        if st is not None:
            deps.append(st.tid)
        if prev_exec is not None:
            deps.append(prev_exec.tid)
        prev_exec = g.add(name, "execute", affinity="big", deps=deps)
    g.validate()
    return g


def simulate_graph(
    graph: TaskGraph,
    order: Sequence[str],
    prep_little: Sequence[float],
    prep_big: Sequence[float],
    exec_big: Sequence[float],
    **kw,
) -> Tuple[float, Dict[str, float]]:
    """Deterministic makespan of a compiled graph — recovers the plan
    structure (big preps, lane queues) from the graph's tasks and feeds the
    scheduler's event-driven ``simulate``: proof that the executor and the
    planner model one and the same structure."""
    idx = {n: i for i, n in enumerate(order)}
    big_prep = [idx[n] for n in graph.big_prep_layers()]
    queues = graph.lane_queues()
    lanes = sorted(queues)
    little_queues = [[idx[n] for n in queues[j]] for j in lanes]
    # weightless layers emit no prep chain; account them as (near-zero-cost)
    # big preps so the simulator sees every layer prepared
    placed = set(big_prep) | {i for q in little_queues for i in q}
    big_prep += [i for i in range(len(order)) if i not in placed]
    return simulate(prep_little, prep_big, exec_big, big_prep,
                    little_queues, **kw)
