"""Plan feasibility as a reusable analyzer (sc-lint pass family 3).

The hierarchical planner historically verified its composed plan with a
bare ``is_feasible`` + shed loop; an infeasible plan produced an opaque
assertion. This module lifts verify+repair out of ``core.altopt`` into an
analyzer any caller (planner, CLI, tests) can reuse:

* ``find_counterexample`` — for an infeasible ``(flagged, order)`` pair,
  the overflowing step plus a *minimal* witness: the smallest (by count,
  greedily largest-first) subset of flagged nodes resident at that step
  whose bytes already exceed the budget, and the in-flight nodes held past
  their last child by the k-worker window slack — i.e. the interleaving
  that realizes the overflow. Feasible plans return ``None``.
* ``repair`` — the planner's shed loop: discard the lowest score-density
  flagged node until no counterexample remains (bit-identical victim order
  to the loop it replaces), returning the repaired set and the
  counterexample that justified each shed.
* ``check_plan`` — Finding-producing wrapper for the sc-lint CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.graph import MVGraph, positions
from .findings import Finding

__all__ = ["Counterexample", "find_counterexample", "repair", "check_plan"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Counterexample:
    """One budget-violating step of a k-worker interleaving."""

    step: int                   # order position where residency peaks
    executing: int              # node index executing at that step
    resident_bytes: float       # total flagged bytes resident there
    budget: float
    witness: tuple[int, ...]    # minimal flagged subset already over budget
    in_flight: tuple[int, ...]  # resident only via the k-1 window slack
    n_workers: int

    def describe(self, graph: MVGraph | None = None) -> str:
        def nm(i: int) -> str:
            if graph is not None and getattr(graph, "names", None):
                return graph.names[i]
            return f"#{i}"

        msg = (
            f"step {self.step} (executing {nm(self.executing)}): "
            f"{len(self.witness)} flagged entries "
            f"[{', '.join(nm(i) for i in self.witness)}] hold "
            f"{self.resident_bytes:.3g} B > budget {self.budget:.3g} B"
        )
        if self.in_flight:
            msg += (
                f"; under k={self.n_workers}, "
                f"[{', '.join(nm(i) for i in self.in_flight)}] stay "
                "resident past their last child (window slack) — the "
                "interleaving that realizes the overflow"
            )
        return msg


def find_counterexample(
    graph: MVGraph,
    flagged: Iterable[int],
    order: Sequence[int],
    budget: float,
    n_workers: int = 1,
) -> Counterexample | None:
    """None iff ``flagged`` fits ``budget`` at every step of ``order`` under
    the worst ``n_workers``-worker interleaving; otherwise the peak step's
    minimal witness."""
    flagged = set(flagged)
    prof = graph.residency_profile(flagged, order, n_workers)
    if not prof:
        return None
    step = max(range(len(prof)), key=prof.__getitem__)
    if prof[step] <= budget + _EPS:
        return None
    pos = positions(order)
    rel = graph.release_pos(order, n_workers)
    lc = graph.last_child_pos(order)
    resident = sorted(
        (i for i in flagged if pos[i] <= step <= rel[i]),
        key=lambda i: graph.sizes[i],
        reverse=True,
    )
    witness: list[int] = []
    acc = 0.0
    for i in resident:
        witness.append(i)
        acc += graph.sizes[i]
        if acc > budget + _EPS:
            break
    in_flight = tuple(i for i in witness if lc[i] < step)
    return Counterexample(
        step=step,
        executing=order[step],
        resident_bytes=prof[step],
        budget=float(budget),
        witness=tuple(witness),
        in_flight=in_flight,
        n_workers=max(int(n_workers), 1),
    )


def repair(
    graph: MVGraph,
    flagged: Iterable[int],
    order: Sequence[int],
    budget: float,
    n_workers: int = 1,
) -> tuple[frozenset[int], list[Counterexample]]:
    """Shed lowest score-density pins until feasible. Victim selection is
    exactly the loop ``hierarchical_plan`` always ran (min score/size), so
    repaired plans are bit-identical to the historical behavior — the gain
    is the returned counterexample trail explaining each shed."""
    flagged = set(flagged)
    trail: list[Counterexample] = []
    while flagged:
        cex = find_counterexample(graph, flagged, order, budget, n_workers)
        if cex is None:
            break
        trail.append(cex)
        flagged.discard(min(
            flagged,
            key=lambda i: graph.scores[i] / max(graph.sizes[i], 1e-12),
        ))
    return frozenset(flagged), trail


def check_plan(
    graph: MVGraph,
    flagged: Iterable[int],
    order: Sequence[int],
    budget: float,
    n_workers: int = 1,
    path: str = "plan",
    symbol: str = "plan",
) -> list[Finding]:
    """Finding-producing feasibility check for the sc-lint CLI/tests."""
    cex = find_counterexample(graph, flagged, order, budget, n_workers)
    if cex is None:
        return []
    return [Finding(
        "plan-infeasible", "error", path, symbol,
        cex.describe(graph),
    )]
