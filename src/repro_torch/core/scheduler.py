"""The kernel scheduler — §3.2 formulation + §3.3 Algorithm 1.

Problem (Eq. 1–2): pick per layer (i) a kernel, (ii) raw-vs-cached weights,
(iii) a core and start time for each operation (read/transform/execute),
minimizing E_{e_N} subject to dependency and single-occupancy constraints.
Nonlinear integer programming — NP-hard — so the paper's heuristic:

  * execution ops always occupy all big cores, in layer order
    (assumption 1; Fig. 6 shows exec multithreads near-linearly);
  * read+transform of a layer are bundled as one *preparation* op placed on
    little cores, one op per core, no multithreading (assumption 2);
  * Algorithm 1: outer loop over Pareto-filtered kernel combinations; inner
    big-core loop (move early preps onto big cores while they idle) and
    little-core balancing loop.

We add two validation baselines beyond the paper: a brute-force optimal
search (small N) over kernel × cache × core-assignment, and a simulated-
annealing search — both used in tests/benchmarks to show Algorithm 1 is
near-optimal at a fraction of the cost.

All decisions are evaluated with ``simulate`` — a deterministic event-driven
executor over profiled per-op costs and a ``CoreModel`` (big.LITTLE factors),
including optional per-core background-load slowdowns and the work-stealing
runtime rule (§3.3 "dealing with hardware dynamics").
"""
from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.profiler import CoreModel, OpProfile


@dataclass(frozen=True)
class Choice:
    """Kernel + cache decision for one layer."""
    kernel: str
    use_cache: bool


@dataclass
class Plan:
    choices: List[Choice]                 # per layer
    big_prep: List[int]                   # layer indices prepped on big cores
    little_queues: List[List[int]]        # per little core: layer indices
    est_makespan: float
    est_breakdown: Dict[str, float] = field(default_factory=dict)
    # I/O queue depth for the async engine's read submissions (planned by
    # plan_read_depth from the same profiled costs as the read-vs-stage
    # split; 1 = sync-equivalent)
    read_depth: int = 1

    def to_dict(self):
        return {
            "choices": [(c.kernel, c.use_cache) for c in self.choices],
            "big_prep": self.big_prep,
            "little_queues": self.little_queues,
            "est_makespan": self.est_makespan,
            "read_depth": self.read_depth,
        }

    @staticmethod
    def from_dict(d):
        return Plan(
            choices=[Choice(k, c) for k, c in d["choices"]],
            big_prep=list(d["big_prep"]),
            little_queues=[list(q) for q in d["little_queues"]],
            est_makespan=d["est_makespan"],
            # plan.json written before the async engine landed: depth 1
            read_depth=int(d.get("read_depth", 1)),
        )


def plan_read_depth(
    read_costs: Sequence[float],
    other_prep_costs: Sequence[float],
    *,
    io_interference: float = 1.0,
    max_depth: int = 8,
) -> int:
    """Queue depth the async engine should keep reads at, from the same
    profiled per-layer costs the read-vs-stage split is planned from.

    The prep pipeline alternates read (disk) with transform+stage (CPU)
    per layer.  When total read time dominates the CPU-side prep work,
    the disk goes idle between submissions unless reads run ahead at
    depth; when CPU work dominates, depth buys nothing — one outstanding
    read is always ready before the CPU needs it.  So the planned depth
    is the ratio of (interference-scaled) read time to the CPU time that
    can overlap it, clamped to [1, max_depth].  §3.2's measured
    ``io_interference`` factor scales the read side: co-running preps
    slow each other's I/O down, which *raises* the depth needed to keep
    the device saturated.  Deterministic, so plan.json round-trips it.
    """
    total_read = float(sum(read_costs)) * max(float(io_interference), 1.0)
    total_other = float(sum(other_prep_costs))
    if total_read <= 0.0:
        return 1
    floor = total_read / max(int(max_depth), 1)
    depth = math.ceil(total_read / max(total_other, floor, 1e-12))
    return max(1, min(int(max_depth), int(depth)))


#: conservative default for an unmeasured peer link — loopback and LAN both
#: clear it comfortably, so an unwarmed estimate only *under*-claims transfer
DEFAULT_LINK_BYTES_PER_S = 200e6


def transfer_estimate(resident_bytes: int, link_bytes_per_s: float = 0.0,
                      *, rtt_s: float = 0.0) -> float:
    """Seconds to stream ``resident_bytes`` of warm state from a peer.

    The peer-transfer cost model, deliberately as simple as
    ``plan_read_depth``'s: one setup round-trip plus bytes over measured
    link bandwidth.  Used in two places with the SAME arithmetic —
    ``FrontDoor`` routing (prefer a non-resident worker when its peer
    fetch beats the local cold estimate) and the per-cold-start decision
    to arm ``fetch_remote`` race tasks at all — so routing and execution
    never disagree about whether a transfer is worth it.  Bandwidth is an
    EWMA measured from completed transfers; before any transfer has
    completed, ``DEFAULT_LINK_BYTES_PER_S`` applies.  Deterministic: no
    wall-clock sampling in here.
    """
    bw = float(link_bytes_per_s) if link_bytes_per_s > 0.0 \
        else DEFAULT_LINK_BYTES_PER_S
    return max(float(rtt_s), 0.0) + max(int(resident_bytes), 0) / bw


# ---------------------------------------------------------------------------
# candidate filtering (Algorithm 1, line 1)
# ---------------------------------------------------------------------------
def pareto_filter(cands: List[Tuple[Choice, float, float]]) -> List[Tuple[Choice, float, float]]:
    """cands: (choice, prep_s, exec_s). Keep the Pareto frontier — drop any
    candidate that is no faster than another in BOTH preparation and
    execution (paper: 'filter out the kernel candidates that exhibit no
    faster operation')."""
    keep = []
    for c in cands:
        dominated = any(
            (o[1] <= c[1] and o[2] <= c[2]) and (o[1] < c[1] or o[2] < c[2])
            for o in cands
        )
        if not dominated:
            keep.append(c)
    # dedupe exact ties
    seen, out = set(), []
    for c in keep:
        key = (round(c[1], 9), round(c[2], 9))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# deterministic simulation (also the runtime model for work stealing)
# ---------------------------------------------------------------------------
def pick_steal_donor(remaining: Dict, costs: Callable[[object], float]):
    """§3.3 work-stealing donor rule, shared by ``simulate`` and the
    executor's ``CorePool``: an idle core steals from the queue with the
    most *remaining preparation time* (and takes that queue's TAIL — the
    layer the exec chain needs last). ``remaining`` maps a queue key to its
    outstanding items; ``costs`` prices one item. Returns the donor key, or
    None when every queue is empty."""
    donor = None
    best = 0.0
    for key, items in remaining.items():
        c = sum(costs(i) for i in items)
        if items and (donor is None or c > best):
            donor, best = key, c
    return donor
def simulate(
    prep_little: Sequence[float],   # per layer: prep time ON A LITTLE CORE
    prep_big: Sequence[float],      # per layer: prep time ON BIG CORES
    exec_big: Sequence[float],      # per layer: exec time ON BIG CORES
    big_prep: Sequence[int],
    little_queues: Sequence[Sequence[int]],
    *,
    core_load: Optional[Dict[int, float]] = None,  # little core -> slowdown ≥1
    big_load: float = 1.0,
    work_stealing: bool = False,
) -> Tuple[float, Dict[str, float]]:
    """Event-driven makespan. Big cores run [big preps in order] then the
    exec chain e_1..e_N (each e_i waits for prep_i and e_{i-1}). Little core
    j runs its queue in order. With work_stealing, an idle little core steals
    the TAIL of the queue with the most remaining prep time (the layer the
    exec chain needs last) — the same rule ``PipelineRuntime`` applies."""
    N = len(exec_big)
    core_load = core_load or {}
    prep_done = [None] * N  # completion time of layer's prep

    queues = [list(q) for q in little_queues]
    t_little = [0.0] * len(queues)
    ptr = [0] * len(queues)

    # big core timeline: preps first
    t_big = 0.0
    for i in big_prep:
        t_big += prep_big[i] * big_load
        prep_done[i] = t_big

    # little cores process queues; with stealing, rebalance dynamically
    if not work_stealing:
        for j, q in enumerate(queues):
            t = 0.0
            for i in q:
                t += prep_little[i] * core_load.get(j, 1.0)
                prep_done[i] = t
    else:
        remaining = {j: list(q) for j, q in enumerate(queues)}
        t_cores = {j: 0.0 for j in remaining}
        while any(remaining.values()):
            # next core to become free takes its own head, or steals
            j = min(t_cores, key=lambda j: t_cores[j])
            if remaining[j]:
                i = remaining[j].pop(0)
            else:
                donor = pick_steal_donor(remaining,
                                         lambda i2: prep_little[i2])
                if donor is None:
                    break
                i = remaining[donor].pop()  # steal the tail
            t_cores[j] += prep_little[i] * core_load.get(j, 1.0)
            prep_done[i] = t_cores[j]
        t_little = list(t_cores.values())

    # exec chain on big cores
    t = t_big
    wait = 0.0
    for i in range(N):
        pd = prep_done[i]
        if pd is None:
            raise ValueError(f"layer {i} was never prepped")
        start = max(t, pd)
        wait += start - t
        t = start + exec_big[i] * big_load
    makespan = t
    return makespan, {
        "big_prep_s": t_big,
        "exec_wait_s": wait,
        "exec_s": sum(exec_big),
        "little_max_s": max([0.0, *[sum(prep_little[i] for i in q) for q in queues]]),
    }


# ---------------------------------------------------------------------------
# Algorithm 1 inner scheduler
# ---------------------------------------------------------------------------
def inner_schedule(
    prep_little: Sequence[float],
    prep_big: Sequence[float],
    exec_big: Sequence[float],
    M_l: int,
    eps: float = 1e-4,
) -> Tuple[List[int], List[List[int]], float]:
    """Algorithm 1 lines 3–20 for one kernel combination."""
    N = len(exec_big)
    if M_l <= 0:
        # no little cores: everything on big
        big_prep = list(range(N))
        return big_prep, [], simulate(
            prep_little, prep_big, exec_big, big_prep, [])[0]

    # line 3: first layer's prep + all exec on big cores
    big_prep = [0]
    s = 1

    # big-core loop (lines 6-11): while little cores are the bottleneck and
    # the big cores can absorb another early prep, move it there. The
    # provisional round-robin totals are maintained incrementally — when s
    # advances, core j's queue becomes core j+1's and the last core takes
    # core 0's minus the promoted layer — so each step is O(M), not O(N).
    totals = [0.0] * M_l
    for i in range(s, N):
        totals[(i - s) % M_l] += prep_little[i]
    T_big = sum(prep_big[i] for i in big_prep)
    for _ in range(N):
        T_little = max(totals) if s < N else 0.0
        if s < N and (prep_big[s] + prep_little[s]) < (T_little - T_big):
            head = totals[0] - prep_little[s]
            totals = totals[1:] + [head]
            big_prep.append(s)
            T_big += prep_big[s]
            s += 1
        else:
            break

    rest = list(range(s, N))
    qs = [rest[j::M_l] for j in range(M_l)]

    # little-core balancing loop (lines 13-20); per-core totals updated in
    # place on each move instead of re-summed
    totals = [sum(prep_little[i] for i in q) for q in qs]
    for _ in range(4 * N):
        if not rest or max(totals) - min(totals) <= eps:
            break
        jmax = max(range(M_l), key=lambda j: totals[j])
        jmin = min(range(M_l), key=lambda j: totals[j])
        gap = totals[jmax] - totals[jmin]
        moved = False
        for i in sorted(qs[jmax], key=lambda i: -prep_little[i]):
            if prep_little[i] < gap / 2:
                qs[jmax].remove(i)
                qs[jmin].append(i)
                totals[jmax] -= prep_little[i]
                totals[jmin] += prep_little[i]
                moved = True
                break
        if not moved:
            break
    for q in qs:
        q.sort()  # earliest layers first: the exec chain needs them first
    mk, _ = simulate(prep_little, prep_big, exec_big, big_prep, qs)
    return big_prep, qs, mk


# ---------------------------------------------------------------------------
# outer search over kernel combinations (Algorithm 1 line 2 & 21-22)
# ---------------------------------------------------------------------------
@dataclass
class LayerCandidates:
    layer: str
    options: List[Tuple[Choice, float, float, float]]
    # (choice, prep_little_s, prep_big_s, exec_big_s)


def _plan_for(combo: Sequence[int], layer_cands: List[LayerCandidates],
              M_l: int) -> Plan:
    pl = [lc.options[k][1] for lc, k in zip(layer_cands, combo)]
    pb = [lc.options[k][2] for lc, k in zip(layer_cands, combo)]
    ex = [lc.options[k][3] for lc, k in zip(layer_cands, combo)]
    big_prep, qs, mk = inner_schedule(pl, pb, ex, M_l)
    return Plan(
        choices=[lc.options[k][0] for lc, k in zip(layer_cands, combo)],
        big_prep=big_prep, little_queues=qs, est_makespan=mk,
    )


def candidate_groups(layer_cands: List[LayerCandidates]) -> List[List[int]]:
    """Indices of layers whose candidate option values are identical —
    shape-class equivalent layers whose profiles were shared (or measured
    equal). Grouping is by VALUE, so per-layer-measured graphs with truly
    identical numbers group the same way as fanned-out shared profiles."""
    by_key: Dict[tuple, List[int]] = {}
    for i, lc in enumerate(layer_cands):
        key = tuple((c.kernel, c.use_cache, pl, pb, ex)
                    for c, pl, pb, ex in lc.options)
        by_key.setdefault(key, []).append(i)
    return [g for g in by_key.values() if len(g) > 1]


def schedule(
    layer_cands: List[LayerCandidates],
    M_l: int,
    *,
    exhaustive_limit: int = 4096,
    memoize: bool = True,
) -> Plan:
    """Outer search. Exact enumeration when the (post-Pareto) combination
    space is small; otherwise greedy coordinate descent from the per-layer
    cold-best choice — each move re-runs the inner scheduler, mirroring the
    paper's 'keeps calibrating through re-profiling' loop.

    Incremental at LLM scale: inner-schedule results are memoized per combo
    (revisited combos across descent rounds are O(1); ``memoize=False``
    runs the identical search without the cache, for parity tests), and
    shape-class-equivalent layers move TOGETHER first — one group move per
    candidate option replaces |group| single-layer probes per round, which
    is what lets hundreds of identical decoder blocks converge in a few
    inner-schedule calls instead of thousands."""
    sizes = [len(lc.options) for lc in layer_cands]
    total = math.prod(sizes)
    if total <= exhaustive_limit:
        best = None
        for combo in itertools.product(*[range(s) for s in sizes]):
            p = _plan_for(combo, layer_cands, M_l)
            if best is None or p.est_makespan < best.est_makespan:
                best = p
        return best

    memo: Optional[Dict[tuple, Plan]] = {} if memoize else None

    def plan_for(combo: Sequence[int]) -> Plan:
        key = tuple(combo)
        if memo is not None:
            p = memo.get(key)
            if p is None:
                memo[key] = p = _plan_for(key, layer_cands, M_l)
            return p
        return _plan_for(key, layer_cands, M_l)

    # greedy start: per-layer min(prep+exec)
    combo = [
        min(range(s), key=lambda k: lc.options[k][1] + lc.options[k][3])
        for s, lc in zip(sizes, layer_cands)
    ]
    best = plan_for(combo)
    groups = candidate_groups(layer_cands)
    improved = True
    while improved:
        improved = False
        # group moves: all members of a shape-class group switch together
        for g in groups:
            for k in range(sizes[g[0]]):
                if all(combo[i] == k for i in g):
                    continue
                trial = list(combo)
                for i in g:
                    trial[i] = k
                p = plan_for(trial)
                if p.est_makespan < best.est_makespan - 1e-9:
                    best, combo, improved = p, trial, True
        # single-layer refinement (position in the chain still matters:
        # e.g. only the tail blocks may afford the cached variant)
        for li in range(len(layer_cands)):
            for k in range(sizes[li]):
                if k == combo[li]:
                    continue
                trial = list(combo)
                trial[li] = k
                p = plan_for(trial)
                if p.est_makespan < best.est_makespan - 1e-9:
                    best, combo, improved = p, trial, True
    return best


def schedule_annealed(
    layer_cands: List[LayerCandidates], M_l: int, *,
    iters: int = 2000, seed: int = 0, t0: float = 0.1,
) -> Plan:
    """Simulated-annealing baseline (beyond-paper, for validation)."""
    rng = random.Random(seed)
    sizes = [len(lc.options) for lc in layer_cands]
    combo = [rng.randrange(s) for s in sizes]
    cur = _plan_for(combo, layer_cands, M_l)
    best = cur
    for it in range(iters):
        li = rng.randrange(len(sizes))
        if sizes[li] == 1:
            continue
        k = rng.randrange(sizes[li])
        trial = list(combo)
        trial[li] = k
        p = _plan_for(trial, layer_cands, M_l)
        temp = t0 * (1 - it / iters) * max(cur.est_makespan, 1e-9)
        if (p.est_makespan < cur.est_makespan or
                rng.random() < math.exp(-(p.est_makespan - cur.est_makespan) / max(temp, 1e-12))):
            cur, combo = p, trial
        if p.est_makespan < best.est_makespan:
            best = p
    return best


def brute_force_optimal(
    layer_cands: List[LayerCandidates], M_l: int,
) -> Plan:
    """Exhaustive optimum over kernel combo × per-layer core assignment
    (big-prefix or little core j), honoring the paper's structural
    assumptions. Exponential — for tests with N ≤ 6 only."""
    N = len(layer_cands)
    assert N <= 7, "brute force is for tiny graphs"
    sizes = [len(lc.options) for lc in layer_cands]
    best = None
    for combo in itertools.product(*[range(s) for s in sizes]):
        pl = [lc.options[k][1] for lc, k in zip(layer_cands, combo)]
        pb = [lc.options[k][2] for lc, k in zip(layer_cands, combo)]
        ex = [lc.options[k][3] for lc, k in zip(layer_cands, combo)]
        for assign in itertools.product(range(M_l + 1), repeat=N):
            big_prep = [i for i in range(N) if assign[i] == 0]
            qs = [[i for i in range(N) if assign[i] == j + 1] for j in range(M_l)]
            mk, _ = simulate(pl, pb, ex, big_prep, qs)
            if best is None or mk < best.est_makespan:
                best = Plan(
                    choices=[lc.options[k][0] for lc, k in zip(layer_cands, combo)],
                    big_prep=big_prep, little_queues=qs, est_makespan=mk,
                )
    return best
