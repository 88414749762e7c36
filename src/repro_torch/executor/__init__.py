"""Persistent asymmetric executor — the online runtime subsystem.

  * ``graph`` — typed task DAGs (``read → transform → stage → execute``,
    per-layer deps, core-affinity tags) compiled from a scheduler ``Plan``;
    the same representation the plan simulator models.
  * ``pool``  — one process-wide ``CorePool`` of persistent big/little
    worker threads that executes task graphs with work stealing by
    remaining prep cost; reused across runs *and models*, with per-job
    trace accounting.

The multi-model server and the LLM bridge are later slices of the port.
"""
from repro_torch.executor.graph import (  # noqa: F401
    OpTrace, PREP_KINDS, Task, TaskGraph, compile_plan, simulate_graph,
)
from repro_torch.executor.pool import (  # noqa: F401
    CorePool, Job, get_core_pool, reset_core_pool,
)
