"""Persistent asymmetric executor — the online runtime subsystem.

  * ``graph``  — typed task DAGs (``read → transform → stage → execute``,
    per-layer deps, core-affinity tags) compiled from a scheduler ``Plan``;
    the same representation the plan simulator models.
  * ``pool``   — one process-wide ``CorePool`` of persistent big/little
    worker threads that executes task graphs with work stealing by
    remaining prep cost; reused across runs *and models*, with per-job
    trace accounting.
  * ``server`` — ``ColdServer``: multi-model cold serving on one shared
    pool (admission control on co-running preps, LRU residency under a
    memory budget, one shared ProfileDB); ``llm_bridge`` turns a cold LLM
    start into first-token serving that overlaps later-layer prep with
    prefill of already-staged early layers, then decodes on a
    ``BatchedServer``.
  * ``frontdoor``/``worker`` — ``FrontDoor``: a supervised fleet of worker
    processes, one ``ColdServer`` each, with lanes, shedding, cost-based
    routing and crash failover; ``warmstate`` streams a sibling's resident
    staged weights to a cold-starting worker, racing its local disk.

``server``/``llm_bridge`` import the engine (which imports the pipeline
facade, which imports ``graph``/``pool``), so they are exposed lazily to
keep ``repro_torch.core.pipeline -> repro_torch.executor`` cycle-free.
"""
from repro_torch.executor.graph import (  # noqa: F401
    OpTrace, PREP_KINDS, Task, TaskGraph, compile_plan, simulate_graph,
)
from repro_torch.executor.pool import (  # noqa: F401
    CorePool, Job, get_core_pool, reset_core_pool,
)

_LAZY = {
    "ColdServer": ("repro_torch.executor.server", "ColdServer"),
    "ColdStart": ("repro_torch.executor.server", "ColdStart"),
    "MemoryBudget": ("repro_torch.executor.server", "MemoryBudget"),
    "FrontDoor": ("repro_torch.executor.frontdoor", "FrontDoor"),
    "ColdLLMResult": ("repro_torch.executor.llm_bridge", "ColdLLMResult"),
    "cold_start_llm": ("repro_torch.executor.llm_bridge", "cold_start_llm"),
}


def __getattr__(name):
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod), attr)
