"""Discrete-event simulator for paper-scale MV refresh runs (§VI).

Paper-scale experiments (Figs. 9–14, Tables IV–V: 100 GB–1 TB TPC-DS
datasets on a Presto cluster) run through the shared execution engine's
discrete-event backend (``engine.simulate_events``):
``n_workers`` genuine compute channels (each executes whole refresh
statements, blocking on its own reads/writes) plus background materialization
channels (the Fig. 6 write-behind). Per-node costs come from the same
CostModel used to compute speedup scores; the *real* Controller (executor.py)
validates the same scheduling core end-to-end on real data at laptop scale.

Modes:
* ``serial`` — no catalog; every read/write blocks (the "No opt" baseline).
* ``sc``     — S/C: flagged outputs are created in memory, children read them
               at memory speed, materialization overlaps downstream compute.
* ``lru``    — the paper's LRU baseline: a result cache of the same byte
               budget; reads hit the cache, writes always block.
"""
from __future__ import annotations

from ..core.altopt import Plan
from ..core.speedup import PAPER_COST_MODEL, CostModel
from .engine import SimReport, simulate_events
from .workloads import Workload

__all__ = ["SimReport", "simulate", "simulate_scenario", "speedup"]


def simulate_scenario(*args, **kwargs):
    """Multi-round full-vs-incremental refresh scenario (paper's update-type
    axis) on the discrete-event backend — see ``mv.incremental``."""
    from .incremental import simulate_scenario as _sim

    return _sim(*args, **kwargs)


def simulate(
    workload: Workload,
    plan: Plan,
    cost_model: CostModel = PAPER_COST_MODEL,
    mode: str = "sc",
    n_workers: int = 1,
    lru_budget: float | None = None,
    n_writers: int | None = None,
) -> SimReport:
    """Simulate an MV refresh run on ``n_workers`` compute channels (the
    paper's multi-node Presto cluster, Table V). Unlike the old
    compute-division approximation, each channel executes whole statements
    under the engine's dispatch discipline, so end-to-end time respects both
    the DAG's critical path and the plan-order memory guarantees."""
    return simulate_events(
        workload,
        plan,
        cost_model,
        mode=mode,
        n_workers=n_workers,
        lru_budget=lru_budget,
        n_writers=n_writers,
    )


def speedup(
    workload: Workload,
    plan: Plan,
    cost_model: CostModel = PAPER_COST_MODEL,
    n_workers: int = 1,
    baseline_mode: str = "serial",
    lru_budget: float | None = None,
) -> float:
    from ..core.altopt import serial_plan

    base = simulate(
        workload,
        serial_plan(workload.to_graph(cost_model)),
        cost_model,
        mode=baseline_mode,
        n_workers=n_workers,
        lru_budget=lru_budget,
    )
    ours = simulate(workload, plan, cost_model, mode="sc", n_workers=n_workers)
    return base.end_to_end / ours.end_to_end
