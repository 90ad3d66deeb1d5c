"""S/C Opt Nodes — exact solution via multidimensional 0-1 knapsack (paper §V-A).

Implements the paper's Algorithm 1 (``SimplifiedMKP``):

1. exclude nodes with ``s_i > M`` or ``t_i == 0`` (never worth/feasible alone);
2. extract resident-set constraints ``V_i`` under the given execution order;
3. drop redundant constraints (non-maximal: ``V_i ⊊ V_j``; trivial:
   ``Σ_{j∈V_i} s_j ≤ M``);
4. solve the remaining binary MKP with branch-and-bound
   (``maximize Σ x_i t_i  s.t.  Σ_{j∈V_i} x_j s_j ≤ M  ∀i``);
5. nodes appearing in no constraint (and not excluded) are trivially flagged.

The paper uses the OR-Tools BnB solver; OR-Tools is not available offline, so
``branch_and_bound_mkp`` below is our own implementation (ratio-ordered DFS
with a per-constraint fractional-relaxation upper bound). It is exact up to a
node-expansion budget; tests validate it against brute force on small
instances. Selector baselines from §VI-A (Greedy / Random / Ratio [60]) live
here too, behind the common ``solve_nodes`` entry point.

Scores are rounded to the nearest integer inside the solver (paper
footnote 3); ties and the returned set use the original float scores.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

from .graph import MVGraph


# ---------------------------------------------------------------------------
# Constraint extraction (Algorithm 1, lines 1-7)
# ---------------------------------------------------------------------------

def excluded_nodes(graph: MVGraph, budget: float) -> frozenset[int]:
    """V_exclude = {v_i | s_i > M  or  t_i == 0}."""
    return frozenset(
        i
        for i in range(graph.n)
        if graph.sizes[i] > budget or graph.scores[i] <= 0.0
    )


def get_constraints(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    exclude: frozenset[int],
    n_workers: int = 1,
) -> list[frozenset[int]]:
    """Maximal, non-trivial resident-set constraints (paper ``GetConstraints``).

    ``n_workers > 1`` widens each node's residency window by the engine's
    out-of-order completion slack, so the selected flag set stays feasible
    under every k-worker interleaving (DESIGN.md §2).
    """
    sets = graph.resident_sets(order, exclude, n_workers)
    # Deduplicate, drop trivial (cannot be violated even if all flagged).
    uniq: dict[frozenset[int], None] = {}
    for s in sets:
        if not s:
            continue
        if sum(graph.sizes[j] for j in s) <= budget + 1e-9:
            continue
        uniq.setdefault(s, None)
    cand = list(uniq)
    # Keep only maximal sets. Use int bitmasks for fast subset tests.
    masks = [_mask(s) for s in cand]
    keep: list[frozenset[int]] = []
    for i, (s, m) in enumerate(zip(cand, masks)):
        maximal = True
        for j, m2 in enumerate(masks):
            if i != j and m | m2 == m2 and m != m2:
                maximal = False
                break
            if i < j and m == m2:
                maximal = False  # duplicate safety (dict already dedupes)
                break
        if maximal:
            keep.append(s)
    return keep


def _mask(s: frozenset[int]) -> int:
    m = 0
    for i in s:
        m |= 1 << i
    return m


# ---------------------------------------------------------------------------
# Branch-and-bound binary MKP (our replacement for OR-Tools' BnB)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MKPResult:
    chosen: frozenset[int]
    objective: float
    optimal: bool  # False if the node-expansion budget was exhausted
    expansions: int = 0


def branch_and_bound_mkp(
    items: Sequence[int],
    profits: dict[int, float],
    weights: dict[int, float],
    constraints: Sequence[frozenset[int]],
    budget: float,
    max_expansions: int = 200_000,
) -> MKPResult:
    """Maximize Σ profits[i]·x_i  s.t. for every constraint C:
    Σ_{i∈C} weights[i]·x_i ≤ budget.

    DFS over items sorted by profit density, with an upper bound from the
    fractional relaxation of the single tightest constraint (dropping all
    other constraints only increases the optimum, so the bound is valid).
    """
    # Integer-round profits (paper footnote 3) for the search; keep >=1 for
    # any strictly positive score so rounding never erases a benefit.
    iprof = {
        i: max(1, round(profits[i])) if profits[i] > 0 else 0 for i in items
    }
    order = sorted(
        items, key=lambda i: (-(iprof[i] / max(weights[i], 1e-12)), weights[i])
    )
    cons = [tuple(sorted(c)) for c in constraints]
    item_cons: dict[int, list[int]] = {i: [] for i in items}
    for ci, c in enumerate(cons):
        for i in c:
            if i in item_cons:
                item_cons[i].append(ci)
    caps = [budget] * len(cons)

    best_set: list[int] = []
    best_val = 0
    expansions = 0
    exhausted = False

    # Suffix profit sums for a cheap generic bound.
    suffix = [0] * (len(order) + 1)
    for k in range(len(order) - 1, -1, -1):
        suffix[k] = suffix[k + 1] + iprof[order[k]]

    def bound(k: int, cur: int, caps_now: list[float]) -> float:
        """Upper bound for completing from item index k."""
        generic = cur + suffix[k]
        if not cons:
            return generic
        # Fractional knapsack on the tightest constraint only.
        ci = min(range(len(cons)), key=lambda c: caps_now[c])
        cap = caps_now[ci]
        in_c = set(cons[ci])
        ub = cur
        frac_done = False
        for idx in range(k, len(order)):
            i = order[idx]
            if i not in in_c:
                ub += iprof[i]  # unconstrained under this relaxation
            elif not frac_done:
                w = weights[i]
                if w <= cap:
                    cap -= w
                    ub += iprof[i]
                else:
                    if w > 0:
                        ub += iprof[i] * (cap / w)
                    frac_done = True  # constraint full; later in-c items add 0
        return min(ub, generic)

    # Explicit-stack DFS (include branch explored first, matching the
    # recursive formulation bitwise): partition-expanded graphs can have
    # thousands of items, far past CPython's recursion limit. "undo" frames
    # restore the capacity/chosen mutations when an include subtree is done.
    chosen: list[int] = []
    stack: list[tuple] = [("visit", 0, 0)]
    while stack:
        frame = stack.pop()
        if frame[0] == "undo":
            i = frame[1]
            chosen.pop()
            for ci in item_cons[i]:
                caps[ci] += weights[i]
            continue
        _, k, cur = frame
        expansions += 1
        if expansions > max_expansions:
            exhausted = True
            break  # best_val/best_set already hold the incumbent
        if cur > best_val:
            best_val = cur
            best_set = list(chosen)
        if k >= len(order):
            continue
        if bound(k, cur, caps) <= best_val:
            continue
        i = order[k]
        w = weights[i]
        # LIFO: push the exclude branch first so the include branch (and
        # its undo) run before it, exactly like the recursive include-first
        stack.append(("visit", k + 1, cur))
        if all(caps[ci] >= w - 1e-9 for ci in item_cons[i]):
            for ci in item_cons[i]:
                caps[ci] -= w
            chosen.append(i)
            stack.append(("undo", i))
            stack.append(("visit", k + 1, cur + iprof[i]))
    chosen = frozenset(best_set)
    return MKPResult(
        chosen=chosen,
        objective=sum(profits[i] for i in chosen),
        optimal=not exhausted,
        expansions=expansions,
    )


# ---------------------------------------------------------------------------
# Algorithm 1: SimplifiedMKP
# ---------------------------------------------------------------------------

def simplified_mkp(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    max_expansions: int = 200_000,
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> frozenset[int]:
    """The paper's exact node-selection step (Algorithm 1).

    ``max_entry_bytes`` additionally excludes any single node larger than
    that cap — used when ``budget`` is an aggregate over cluster nodes but
    one entry must still fit a single node's catalog share.
    """
    cap = budget if max_entry_bytes is None else min(budget, max_entry_bytes)
    exclude = excluded_nodes(graph, cap)
    cons = get_constraints(graph, budget, order, exclude, n_workers)
    v_mkp: set[int] = set().union(*cons) if cons else set()
    if v_mkp:
        res = branch_and_bound_mkp(
            items=sorted(v_mkp),
            profits={i: graph.scores[i] for i in v_mkp},
            weights={i: graph.sizes[i] for i in v_mkp},
            constraints=cons,
            budget=budget,
            max_expansions=max_expansions,
        )
        chosen = set(res.chosen)
    else:
        chosen = set()
    # Line 9: nodes in no constraint (and not excluded) are trivially flagged.
    chosen |= set(range(graph.n)) - v_mkp - set(exclude)
    return frozenset(chosen)


# ---------------------------------------------------------------------------
# Selector baselines (paper §VI-A): Greedy / Random / Ratio-based [60]
# ---------------------------------------------------------------------------

def _flag_incrementally(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    candidates: Sequence[int],
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> frozenset[int]:
    """Flag candidates one at a time if doing so keeps peak memory ≤ M."""
    pos_order = list(order)
    lc = graph.release_pos(pos_order, n_workers)
    from .graph import positions

    pos = positions(pos_order)
    cap = budget if max_entry_bytes is None else min(budget, max_entry_bytes)
    prof = [0.0] * graph.n
    chosen: set[int] = set()
    for i in candidates:
        if graph.sizes[i] > cap or graph.scores[i] <= 0:
            continue
        lo, hi = pos[i], lc[i]
        if max(prof[lo : hi + 1], default=0.0) + graph.sizes[i] <= budget + 1e-9:
            for k in range(lo, hi + 1):
                prof[k] += graph.sizes[i]
            chosen.add(i)
    return frozenset(chosen)


def greedy_select(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> frozenset[int]:
    """Iterate nodes in execution order; flag if feasible."""
    return _flag_incrementally(
        graph, budget, order, list(order), n_workers, max_entry_bytes
    )


def random_select(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    seed: int = 0,
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> frozenset[int]:
    rng = random.Random(seed)
    cand = list(range(graph.n))
    rng.shuffle(cand)
    return _flag_incrementally(graph, budget, order, cand, n_workers, max_entry_bytes)


def ratio_select(
    graph: MVGraph,
    budget: float,
    order: Sequence[int],
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> frozenset[int]:
    """Ratio-based selection [60]: highest score/size first."""
    cand = sorted(
        range(graph.n),
        key=lambda i: -(graph.scores[i] / max(graph.sizes[i], 1e-12)),
    )
    return _flag_incrementally(graph, budget, order, cand, n_workers, max_entry_bytes)


# ---------------------------------------------------------------------------
# Hierarchical planning: the outer knapsack over per-MV partition columns
# ---------------------------------------------------------------------------

def greedy_column_select(
    curves: Sequence,
    budget: float,
    windows: Sequence[Sequence[tuple[int, int]]],
    n_steps: int,
    max_entry_bytes: float | None = None,
) -> list[list[int]]:
    """Select one partition column per MV under windowed residency budgets.

    The outer knapsack of the hierarchical partitioned planner (DESIGN.md
    §8). ``curves`` are per-MV ``BenefitCurve``s (density-ranked partitions
    with their sizes/scores); ``windows[v][p] = (enter, release)`` is the
    residency window — in plan steps, ``n_steps`` of them — that partition
    ``p`` of MV ``v`` would occupy if pinned under the current execution
    order (for the partition-major orders the hierarchical planner emits,
    these are the *exact* expanded k-worker windows of DESIGN.md §2).

    Because each curve's marginal densities are non-increasing, a single
    global density-ordered greedy scan selects a prefix of every MV's
    ranking — i.e. one "pin-the-top-j" column per MV — the Dantzig greedy
    for a multiple-choice knapsack with concave choice frontiers. A
    partition that no longer fits the step profile is skipped (not frozen):
    a later, smaller partition of the same MV may still fit, so a selection
    is a column with at most a few density-ordered gaps.

    Partitions larger than ``min(budget, max_entry_bytes)`` or with
    non-positive score are never selected. Returns the chosen partition ids
    per MV (subset of ``curves[v].parts``, in ranking order). The selection
    satisfies ``profile[step] <= budget`` at every step, each pinned
    partition charged over its own window.
    """
    import heapq

    cap = budget if max_entry_bytes is None else min(budget, max_entry_bytes)
    prof = [0.0] * max(n_steps, 1)
    chosen: list[list[int]] = [[] for _ in curves]

    def density(v: int, j: int) -> float:
        return curves[v].scores[j] / max(curves[v].sizes[j], 1e-12)

    heap: list[tuple[float, int, int]] = []
    for v, c in enumerate(curves):
        if c.parts:
            heap.append((-density(v, 0), v, 0))
    heapq.heapify(heap)
    while heap:
        _, v, j = heapq.heappop(heap)
        c = curves[v]
        if j + 1 < len(c.parts):
            heapq.heappush(heap, (-density(v, j + 1), v, j + 1))
        size, score = c.sizes[j], c.scores[j]
        if score <= 0.0 or size > cap:
            continue
        lo, hi = windows[v][c.parts[j]]
        if max(prof[lo : hi + 1], default=0.0) + size <= budget + 1e-9:
            for k in range(lo, hi + 1):
                prof[k] += size
            chosen[v].append(c.parts[j])
    return chosen


NodeSolver = Callable[[MVGraph, float, Sequence[int]], frozenset[int]]

NODE_SOLVERS: dict[str, NodeSolver] = {
    "mkp": simplified_mkp,
    "greedy": greedy_select,
    "random": random_select,
    "ratio": ratio_select,
}
