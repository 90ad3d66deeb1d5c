"""Controller (paper §III-B/C): executes an MV refresh run under a plan.

The Controller is a thin facade over the shared execution engine
(``engine.ThreadedEngine``): k compute worker threads pull ready nodes off
the plan under the engine's in-order/window-k dispatch discipline. For each
node: gather inputs (from the Memory Catalog when the parent is flagged and
resident, else from external storage), run the node's compute function, then
either

* flagged  → create the output *in the catalog* and enqueue its
  materialization on the background writer (Fig. 6 t2: persistence overlaps
  downstream compute), or
* unflagged → write it synchronously to storage (the baseline path).

A flagged node is released from the catalog as soon as its last child has
completed. The run only concludes when every MV is durable on storage — the
paper's SLA property. On the card, the catalog's byte budget bounds the
bytes of intermediate tables resident in device memory.

Crash recovery: the store's manifest records completed materializations
atomically; ``run(resume=True)`` skips them and recomputes the rest.
``n_compute_workers=1`` (the default) reproduces the paper's serial
statement stream exactly.
"""
from __future__ import annotations

import dataclasses

from ..core.altopt import Plan
from .engine import InjectedCrash, RunReport, ThreadedEngine
from .storage import DiskStore
from .workloads import Workload

__all__ = ["Controller", "InjectedCrash", "RunReport", "calibrate_sizes"]


class Controller:
    def __init__(
        self,
        workload: Workload,
        store: DiskStore,
        budget_bytes: float,
        n_writers: int = 1,
        n_compute_workers: int = 1,
    ):
        self.workload = workload
        self.store = store
        self.budget = float(budget_bytes)
        self.n_writers = n_writers
        self.n_compute_workers = n_compute_workers

    def run(
        self,
        plan: Plan,
        resume: bool = False,
        crash_after: int | None = None,
    ) -> RunReport:
        engine = ThreadedEngine(
            self.workload,
            self.store,
            self.budget,
            n_compute_workers=self.n_compute_workers,
            n_writers=self.n_writers,
        )
        return engine.run(plan, resume=resume, crash_after=crash_after)

    def run_scenario(self, spec, cost_model, optimize: bool = True):
        """Multi-round refresh under an ``UpdateSpec`` (full vs incremental
        updates) — see ``mv.incremental.run_scenario``."""
        from .incremental import run_scenario

        return run_scenario(
            self.workload,
            self.store,
            self.budget,
            spec,
            cost_model,
            n_compute_workers=self.n_compute_workers,
            n_writers=self.n_writers,
            optimize=optimize,
        )


def calibrate_sizes(workload: Workload, store: DiskStore) -> Workload:
    """One observation run (the paper's 'execution metadata from past runs'):
    execute serially, record true output sizes into the workload copy."""
    from ..core.altopt import serial_plan

    Controller(workload, store, budget_bytes=0.0).run(
        serial_plan(workload.to_graph())
    )
    manifest = store.manifest()
    new_nodes = [
        dataclasses.replace(n, size=max(float(manifest.get(n.name, n.size)), 1.0))
        for n in workload.nodes
    ]
    return Workload(name=workload.name, nodes=new_nodes, meta=dict(workload.meta))
