"""S/C Opt Order — MA-DFS and ordering baselines (paper §V-B, §VI-A).

MA-DFS is a DFS-based topological scheduler: it finishes a branch of execution
before starting a new one (minimizing the gap between a node's execution and
its children's executions — which is exactly what frees flagged nodes early),
and tie-breaks toward the candidate with the **lowest actual memory
consumption** (``s_i`` if flagged, else 0; then smaller size, then index).
Scheduling the cheap branches first means the large flagged dependencies are
computed last, immediately before their consumers, minimizing their residency
(paper Fig. 8).

Baselines:
* ``random_dfs``  — same DFS skeleton, random tie-breaking (ablation).
* ``simulated_annealing`` — iterative pairwise swaps on the order [64].
* ``separator``   — recursive divide-and-conquer ordering [70], [71].
"""
from __future__ import annotations

import math
import random
from typing import Callable, Iterable, Sequence

from .graph import MVGraph, positions


# ---------------------------------------------------------------------------
# DFS-based schedulers
# ---------------------------------------------------------------------------

def _dfs_schedule(
    graph: MVGraph,
    tiebreak: Callable[[int], tuple],
) -> list[int]:
    """DFS-like topological schedule.

    After executing a node we prefer to continue with one of its now-ready
    children (finish the branch); if none is ready we backtrack along the
    executed path; if the path is exhausted we pick among globally ready
    nodes. All choices use ``tiebreak`` (ascending).
    """
    indeg = [len(graph.parents[i]) for i in range(graph.n)]
    ready = {i for i in range(graph.n) if indeg[i] == 0}
    order: list[int] = []
    path: list[int] = []  # stack of executed nodes we may still deepen from

    def pick(cands: Iterable[int]) -> int:
        return min(cands, key=tiebreak)

    while len(order) < graph.n:
        nxt = -1
        while path:
            ready_children = [c for c in graph.children[path[-1]] if c in ready]
            if ready_children:
                nxt = pick(ready_children)
                break
            path.pop()
        if nxt < 0:
            nxt = pick(ready)
        ready.discard(nxt)
        order.append(nxt)
        path.append(nxt)
        for c in graph.children[nxt]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.add(c)
    return order


def ma_dfs(
    graph: MVGraph,
    flagged: frozenset[int],
    budget: float | None = None,
) -> list[int]:
    """Memory-aware DFS: tie-break by actual memory consumption (paper §V-B)."""

    def key(i: int) -> tuple:
        actual = graph.sizes[i] if i in flagged else 0.0
        return (actual, graph.sizes[i], i)

    return _dfs_schedule(graph, key)


def random_dfs(graph: MVGraph, flagged: frozenset[int], seed: int = 0) -> list[int]:
    rng = random.Random(seed)
    salt = {i: rng.random() for i in range(graph.n)}

    def key(i: int) -> tuple:
        return (salt[i],)

    return _dfs_schedule(graph, key)


# ---------------------------------------------------------------------------
# Simulated annealing on the order (baseline [64])
# ---------------------------------------------------------------------------

def _swap_valid(graph: MVGraph, order: list[int], i: int, j: int) -> bool:
    """Is swapping positions i<j topologically valid?"""
    vi, vj = order[i], order[j]
    between = order[i + 1 : j]
    ci = set(graph.children[vi])
    pj = set(graph.parents[vj])
    if vj in ci:
        return False
    if any(b in ci for b in between):  # vi must not precede a child
        return False
    if any(b in pj for b in between):  # vj must not follow a parent
        return False
    return True


def simulated_annealing(
    graph: MVGraph,
    flagged: frozenset[int],
    init_order: Sequence[int] | None = None,
    iters: int = 10_000,
    seed: int = 0,
    t0: float = 1.0,
) -> list[int]:
    rng = random.Random(seed)
    order = list(init_order) if init_order is not None else graph.topological_order()
    cur = graph.avg_memory(flagged, order)
    best, best_val = list(order), cur
    for it in range(iters):
        if graph.n < 2:
            break
        i, j = sorted(rng.sample(range(graph.n), 2))
        if not _swap_valid(graph, order, i, j):
            continue
        order[i], order[j] = order[j], order[i]
        val = graph.avg_memory(flagged, order)
        temp = t0 * (1.0 - it / iters) + 1e-9
        scale = max(best_val, 1.0)
        if val <= cur or rng.random() < math.exp(-(val - cur) / (temp * scale)):
            cur = val
            if val < best_val:
                best_val, best = val, list(order)
        else:
            order[i], order[j] = order[j], order[i]  # revert
    return best


# ---------------------------------------------------------------------------
# Recursive separator ordering (baseline [70], [71])
# ---------------------------------------------------------------------------

def separator(
    graph: MVGraph,
    flagged: frozenset[int],
    seed: int = 0,
) -> list[int]:
    """Divide-and-conquer: recursively split the node set into a prefix
    (a down-set, grown greedily to minimize flagged bytes crossing the cut)
    and a suffix, until singletons remain. The concatenation of cuts defines
    the execution order."""

    def split(nodes: list[int]) -> list[int]:
        if len(nodes) <= 1:
            return list(nodes)
        nset = set(nodes)
        half = len(nodes) // 2
        indeg = {
            v: sum(1 for p in graph.parents[v] if p in nset) for v in nodes
        }
        ready = sorted(v for v in nodes if indeg[v] == 0)
        prefix: list[int] = []
        in_prefix: set[int] = set()
        while ready and len(prefix) < half:
            # greedy: adding v costs flagged bytes iff v is flagged and has a
            # child outside the prefix-to-be (i.e., crossing the cut).
            def cost(v: int) -> tuple:
                crossing = (
                    graph.sizes[v]
                    if v in flagged
                    and any(c in nset and c not in in_prefix for c in graph.children[v])
                    else 0.0
                )
                return (crossing, graph.sizes[v], v)

            v = min(ready, key=cost)
            ready.remove(v)
            prefix.append(v)
            in_prefix.add(v)
            for c in graph.children[v]:
                if c in nset:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        ready.append(c)
        suffix = [v for v in nodes if v not in in_prefix]
        return split(prefix) + split(suffix)

    return split(graph.topological_order())


OrderSolver = Callable[[MVGraph, frozenset[int]], list[int]]

ORDER_SOLVERS: dict[str, OrderSolver] = {
    "madfs": ma_dfs,
    "random_dfs": random_dfs,
    "sa": simulated_annealing,
    "separator": separator,
}
