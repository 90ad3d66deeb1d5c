"""S/C Opt — alternating optimization (paper Algorithm 2).

Starting from a plain topological order and an empty flag set, alternate:

1. ``U_new = solve_nodes(G, S, T, M, tau)``      (S/C Opt Nodes; default MKP)
2. stop if ``U_new`` does not improve the total speedup score;
3. ``tau_new = solve_order(G, U_new)``           (S/C Opt Order; default MA-DFS)
4. stop (returning the previous feasible pair) if ``tau_new`` violates the
   peak-memory constraint;
5. repeat.

The paper's pseudocode (line 5) compares total flagged *sizes*; its text
("the total speedup score of U must increase in each iteration") uses the
objective — we follow the text and compare scores, which also guarantees
convergence. A hard iteration cap is a safety net (the paper observes < 10
iterations at 100 nodes).

Layer contract: every function here returns a ``Plan`` (or wraps one in a
``PartitionedPlan``) that is **feasible** — its flagged set fits ``budget``
bytes at every step under the worst-case ``n_workers``-worker interleaving
of its order (DESIGN.md §2) — and whose order is topological. Callers
(engine, scenarios, benchmarks) rely on that invariant unconditionally;
both ``solve`` and ``hierarchical_plan`` assert it before returning.

Three entry points share it:

* ``solve``              — Algorithm 2 on any graph (the flat/exact path);
* ``solve_partitioned``  — ``solve`` over the P-way partition expansion:
  fractional (per-partition) residency, DESIGN.md §7;
* ``solve_hierarchical`` — the decomposed partition-granular solve that
  stays fast at large ``n·P``, exact-fallback below ``FLAT_THRESHOLD``
  and always at P=1, DESIGN.md §8.

MQO-merged graphs (``mv.mqo``, DESIGN.md §11) need no special casing here:
merging rewires every consumer of a shared subexpression onto one
representative node, so the representative arrives with its fan-out already
multiplied into ``n_children`` — ``speedup.score_graph`` prices each extra
consumer as one more saved disk read, and the MKP sees a shared
intermediate as exactly the high-score, long-residency-window candidate the
paper's objective says it is. The solvers' only obligations stay what they
were: feasibility under the budget and a topological order (the merged
graph is still a DAG — representatives are minimum-index class members, so
parents precede children).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from .graph import MVGraph
from .madfs import ORDER_SOLVERS
from .mkp import NODE_SOLVERS, greedy_column_select


@dataclasses.dataclass(frozen=True)
class Plan:
    """An MV refresh plan: execution order + nodes to keep in memory.

    ``n_workers`` records the concurrency level the plan was verified
    feasible for; ``peak_memory`` is the worst case over the engine's
    k-worker interleavings at that level (serial peak when 1).
    """

    order: tuple[int, ...]
    flagged: frozenset[int]
    score: float
    peak_memory: float
    avg_memory: float
    iterations: int
    solve_seconds: float
    n_workers: int = 1

    def summary(self, graph: MVGraph) -> str:
        names = [graph.names[i] for i in self.order]
        flags = sorted(graph.names[i] for i in self.flagged)
        return (
            f"order: {' -> '.join(names)}\n"
            f"flagged ({len(flags)}): {', '.join(flags)}\n"
            f"score={self.score:.3f}s  peak={self.peak_memory:.3e}B "
            f"avg={self.avg_memory:.3e}B  iters={self.iterations}"
        )


def solve(
    graph: MVGraph,
    budget: float,
    node_solver: str = "mkp",
    order_solver: str = "madfs",
    init_order: Sequence[int] | None = None,
    max_iters: int = 50,
    node_kwargs: dict | None = None,
    order_kwargs: dict | None = None,
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
) -> Plan:
    """Solve S/C Opt with alternating optimization (Algorithm 2).

    ``n_workers=k`` makes every feasibility check (and the MKP resident-set
    constraints) use the k-worker worst-case residency windows, so the
    returned plan stays within budget under any interleaving the execution
    engine can produce with k compute workers (DESIGN.md §2).
    ``max_entry_bytes`` caps single flagged entries below the aggregate
    budget (e.g. one cluster node's catalog share).
    """
    t_start = time.perf_counter()
    nodes_fn = NODE_SOLVERS[node_solver]
    order_fn = ORDER_SOLVERS[order_solver]
    node_kwargs = dict(node_kwargs or {})
    order_kwargs = order_kwargs or {}
    n_workers = max(int(n_workers), 1)
    node_kwargs.setdefault("n_workers", n_workers)
    if max_entry_bytes is not None:
        node_kwargs.setdefault("max_entry_bytes", max_entry_bytes)

    tau = list(init_order) if init_order is not None else graph.topological_order()
    if not graph.is_topological(tau):
        raise ValueError("init_order is not topological")
    flagged: frozenset[int] = frozenset()
    score = 0.0
    iters = 0

    for iters in range(1, max_iters + 1):
        u_new = nodes_fn(graph, budget, tau, **node_kwargs)
        new_score = graph.total_score(u_new)
        if new_score <= score + 1e-12:
            break
        flagged, score = u_new, new_score
        tau_new = order_fn(graph, flagged, **order_kwargs)
        if not graph.is_topological(tau_new) or not graph.is_feasible(
            flagged, tau_new, budget, n_workers
        ):
            break  # keep previous feasible order (paper §V-B last paragraph)
        tau = tau_new

    # Invariant: the returned plan is always feasible.
    assert graph.is_feasible(
        flagged, tau, budget, n_workers
    ), "altopt produced infeasible plan"
    return Plan(
        order=tuple(tau),
        flagged=flagged,
        score=score,
        peak_memory=graph.peak_memory(flagged, tau, n_workers),
        avg_memory=graph.avg_memory(flagged, tau),
        iterations=iters,
        solve_seconds=time.perf_counter() - t_start,
        n_workers=n_workers,
    )


@dataclasses.dataclass(frozen=True)
class PartitionedPlan:
    """A partition-granular refresh plan (DESIGN.md §7).

    ``plan`` is an ordinary ``Plan`` over the P-way expanded graph — the
    engine executes it directly, dispatching ``(mv, partition)`` tasks.
    ``index`` maps every expanded node back to its ``(node, partition)``
    pair, so ``flagged_partitions`` reads off *which partitions of which MV*
    the objective chose to pin: fractional residency, with the whole-MV plan
    as the ``n_partitions=1`` degenerate case.
    """

    plan: Plan
    n_partitions: int
    index: tuple[tuple[int, int], ...]

    @property
    def flagged_partitions(self) -> frozenset[tuple[int, int]]:
        return frozenset(self.index[i] for i in self.plan.flagged)

    def residency_fraction(self, v: int) -> float:
        """Fraction of node ``v``'s partitions the plan keeps resident."""
        flagged = sum(1 for n, _ in self.flagged_partitions if n == v)
        return flagged / self.n_partitions


def solve_partitioned(
    graph: MVGraph,
    budget: float,
    n_partitions: int,
    cost_model=None,
    shares: Sequence[float] | None = None,
    **solve_kw,
) -> PartitionedPlan:
    """Solve S/C Opt at partition granularity.

    The whole-MV graph is expanded P ways (co-partitioned edges, sizes and
    scores split by ``shares``, rescored per partition when ``cost_model``
    is given) and Algorithm 2 runs unchanged over the expansion: the MKP now
    chooses *which partitions of which MV* to pin within the byte budget —
    an MV too large to flag whole contributes whichever partitions fit.
    Feasibility inherits the k-worker window guarantee of ``solve``: the
    returned plan fits the budget under every interleaving the engine can
    produce with ``solve_kw['n_workers']`` workers. ``n_partitions=1``
    degenerates to exactly ``solve(graph, budget, **solve_kw)``."""
    P = max(int(n_partitions), 1)
    if P == 1:
        expanded, index = graph, tuple((v, 0) for v in range(graph.n))
    else:
        expanded, index = graph.expand_partitions(P, shares)
    if cost_model is not None:
        # rescore at every P — including the P=1 degenerate case — so a
        # P-sweep compares plans under one objective, not whatever model
        # originally scored ``graph``
        from .speedup import rescore

        expanded = rescore(expanded, cost_model)
    return PartitionedPlan(
        plan=solve(expanded, budget, **solve_kw),
        n_partitions=P,
        index=index,
    )


# n·P at or below this, the flat (exact) partitioned solve stays fast enough
# that the hierarchical decomposition has nothing to buy — and falling back
# keeps small instances bitwise identical to ``solve_partitioned``.
FLAT_THRESHOLD = 256


def hierarchical_plan(
    expanded: MVGraph,
    budget: float,
    n_partitions: int,
    n_workers: int = 1,
    max_entry_bytes: float | None = None,
    order_solver: str = "madfs",
    order_kwargs: dict | None = None,
    max_iters: int | None = None,
    flat_threshold: int = FLAT_THRESHOLD,
) -> Plan:
    """Hierarchical partition-granular solve over an already-expanded graph.

    ``max_iters`` caps the alternation on whichever path runs — it is
    forwarded to the exact-fallback ``solve`` too, so a caller-configured
    planning budget holds on both sides of ``flat_threshold``; ``None``
    means each path's own default (8 for the decomposition, ``solve``'s 50
    for the fallback, keeping the fallback bitwise ``solve_partitioned``).

    ``expanded`` must follow the ``MVGraph.expand_partitions`` index layout
    (node ``v * P + p`` is partition ``p`` of base MV ``v`` — what
    ``partition_workload``'s view graphs and ``score_partitioned_graph``
    produce). Instead of one flat MKP over all ``n·P`` items, the solve
    decomposes (DESIGN.md §8):

    1. **Partition-major order** — the plan runs the whole DAG once per
       partition slice, which is topological (edges are co-partitioned) and
       keeps each pinned partition resident only across its own slice's
       short window — the interleaving the flat planner spends its n·P-item
       MKP/MA-DFS budget rediscovering. The shared within-slice order comes
       from one full Algorithm-2 solve of the *binding* slice (the largest
       byte share — the only slice whose capacity constraints truly bind;
       colder slices reuse its order, which costs them nothing because
       their scaled-down sizes fit almost any order). Slices are sequenced
       coldest-first so the big partitions' background writes land while
       the writer channels still have queue depth to absorb them.
    2. **Inner pass, per MV** — rank the MV's partitions by marginal benefit
       density (``MVGraph.partition_benefit_curves``); the prefix
       configurations of that ranking are the MV's candidate columns.
    3. **Outer knapsack** — a density-ordered greedy over all MVs' columns
       (``mkp.greedy_column_select``) against the exact per-step byte
       profile of the partition-major windows, then a per-slice exact
       refinement: at the chosen order the expanded MKP *separates by
       slice* (a partition's residency window never leaves its slice, up to
       the k-worker spill), so ``simplified_mkp`` on each n-node slice
       subgraph replaces the flat solver's one n·P-item branch-and-bound.
       The better-scoring of the two selections wins.
    4. **Alternate with ordering** — re-run the order solver at base
       granularity against the *selected* bytes per MV (Algorithm 2's
       alternation, n items instead of n·P) until the selected score stops
       improving.

    The returned plan is verified feasible against the expanded graph's own
    k-worker windows — the same invariant ``solve`` guarantees (the
    per-slice refinement ignores the ≤ k-1-step spill across slice
    boundaries, so a repair pass drops lowest-density pins in the rare case
    the boundary overlap overflows). Instances with ``n·P <=
    flat_threshold`` — and always ``P == 1`` — take the exact path: the
    flat ``solve`` over ``expanded``, bitwise identical to
    ``solve_partitioned``.
    """
    P = max(int(n_partitions), 1)
    if expanded.n % P != 0:
        raise ValueError(
            f"graph with {expanded.n} nodes is not a {P}-way expansion"
        )
    if P == 1 or expanded.n <= flat_threshold:
        return solve(
            expanded,
            budget,
            order_solver=order_solver,
            order_kwargs=order_kwargs,
            n_workers=n_workers,
            max_entry_bytes=max_entry_bytes,
            **({} if max_iters is None else {"max_iters": max_iters}),
        )
    max_iters = 8 if max_iters is None else max_iters
    t_start = time.perf_counter()
    n_workers = max(int(n_workers), 1)
    n_base = expanded.n // P
    base_edges = set()
    for a, b in expanded.edges:
        if a % P != b % P:
            raise ValueError(
                "expanded graph has a cross-partition edge; hierarchical "
                "planning requires the co-partitioned expand_partitions "
                "layout"
            )
        base_edges.add((a // P, b // P))
    curves = expanded.partition_benefit_curves(P)
    # per-MV whole sizes/scores only seed the ordering graph; the alternation
    # below re-sizes it with each iteration's *selected* bytes
    whole_scores = [sum(c.scores) for c in curves]
    base = MVGraph(
        n_base, tuple(sorted(base_edges)),
        tuple(sum(c.sizes) for c in curves), tuple(whole_scores),
        names=tuple(expanded.names[v * P].rsplit("@p", 1)[0]
                    for v in range(n_base)),
    )
    from .graph import positions

    def slice_graph(p: int) -> MVGraph:
        return MVGraph(
            n_base,
            base.edges,
            tuple(expanded.sizes[v * P + p] for v in range(n_base)),
            tuple(expanded.scores[v * P + p] for v in range(n_base)),
            base.names,
        )

    # slices execute coldest-first (ascending per-partition byte share):
    # cross-slice edges don't exist, so slice sequencing is free — and
    # saving the big partitions for last lets their background writes land
    # once the writer channels already have queue depth, instead of starving
    # the writers behind the hot slice's long base-table scans at t=0
    slice_bytes = [
        sum(expanded.sizes[v * P + p] for v in range(n_base))
        for p in range(P)
    ]
    slice_seq = sorted(range(P), key=lambda p: slice_bytes[p])
    slice_rank = {p: q for q, p in enumerate(slice_seq)}

    def slice_windows(tau: Sequence[int]) -> list[list[tuple[int, int]]]:
        """Exact expanded residency window of every (v, p) under the
        partition-major order built from base order ``tau``: partition p of
        v executes at step ``rank(p)*n + pos(v)`` and releases at
        ``rank(p)*n + lc(v) + k - 1`` (its last child is in the same slice;
        the engine's window discipline adds the k-1 completion slack)."""
        pos = positions(tau)
        lc = base.last_child_pos(tau)
        top = n_base * P - 1
        return [
            [
                (slice_rank[p] * n_base + pos[v],
                 min(slice_rank[p] * n_base + lc[v] + n_workers - 1, top))
                for p in range(P)
            ]
            for v in range(n_base)
        ]

    def sel_score(chosen: Sequence[Sequence[int]]) -> float:
        return sum(
            expanded.scores[v * P + p]
            for v, pids in enumerate(chosen)
            for p in pids
        )

    from .mkp import simplified_mkp

    def select(tau: Sequence[int]) -> tuple[list[list[int]], float]:
        """Best selection for order ``tau``: greedy over the benefit-curve
        columns (exact windows incl. cross-slice spill) vs the per-slice
        exact MKP refinement (spill-blind; repaired at the end)."""
        g_chosen = greedy_column_select(
            curves, budget, slice_windows(tau), n_base * P, max_entry_bytes
        )
        g_score = sel_score(g_chosen)
        m_chosen: list[list[int]] = [[] for _ in range(n_base)]
        for p in range(P):
            for v in simplified_mkp(
                slice_graph(p), budget, tau,
                n_workers=n_workers, max_entry_bytes=max_entry_bytes,
            ):
                m_chosen[v].append(p)
        m_score = sel_score(m_chosen)
        return (m_chosen, m_score) if m_score > g_score else (
            g_chosen, g_score
        )

    order_fn = ORDER_SOLVERS[order_solver]
    order_kwargs = order_kwargs or {}
    # the binding slice — the only one whose capacity constraints truly
    # bind — gets a full Algorithm-2 solve at base size; its order seeds
    # (and usually decides) the shared within-slice order
    tau = list(
        solve(
            slice_graph(max(range(P), key=lambda p: slice_bytes[p])),
            budget,
            order_solver=order_solver,
            order_kwargs=order_kwargs,
            n_workers=n_workers,
            max_entry_bytes=max_entry_bytes,
        ).order
    )
    # every (selection, order) candidate is feasible by construction (both
    # selectors only pin what fits that order's windows), so the alternation
    # keeps whichever pair scored best instead of gating each reorder on the
    # previous selection's feasibility (altopt.solve's stricter rule exists
    # because its MKP step is too expensive to re-run speculatively)
    chosen: list[list[int]] = [[] for _ in range(n_base)]
    best_tau = list(tau)
    score = 0.0
    iters = 0
    for iters in range(1, max_iters + 1):
        cand, cand_score = select(tau)
        improved = cand_score > score + 1e-12
        if improved:
            chosen, score, best_tau = cand, cand_score, list(tau)
        if iters > 1 and not improved:
            break
        # reorder against the *selected* bytes: MA-DFS sees what the catalog
        # would actually hold under this column choice
        sel_sizes = tuple(
            sum(expanded.sizes[v * P + p] for p in pids)
            for v, pids in enumerate(cand)
        )
        order_g = MVGraph(
            n_base, base.edges, sel_sizes, tuple(whole_scores), base.names
        )
        flagged_base = frozenset(v for v, pids in enumerate(cand) if pids)
        tau_new = order_fn(order_g, flagged_base, **order_kwargs)
        if not base.is_topological(tau_new) or list(tau_new) == list(tau):
            break
        tau = tau_new
    tau = best_tau

    order: list[int] = []
    for p in slice_seq:
        order.extend(v * P + p for v in tau)
    flagged = set(
        v * P + p for v, pids in enumerate(chosen) for p in pids
    )
    # the per-slice MKP ignores the ≤ k-1-step residency spill across slice
    # boundaries; if that overlap overflows the budget, shed the least dense
    # pins until the exact expanded-window check passes. The verify+repair
    # loop lives in analysis.plan_check (shared with sc-lint), which also
    # yields a minimal counterexample interleaving if repair cannot converge.
    from ..analysis.plan_check import find_counterexample, repair

    flagged, _shed_trail = repair(expanded, flagged, order, budget, n_workers)
    cex = find_counterexample(expanded, flagged, order, budget, n_workers)
    assert cex is None, (
        "hierarchical planner produced infeasible plan: "
        + cex.describe(expanded)
    )
    return Plan(
        order=tuple(order),
        flagged=flagged,
        score=expanded.total_score(flagged),
        peak_memory=expanded.peak_memory(flagged, order, n_workers),
        avg_memory=expanded.avg_memory(flagged, order),
        iterations=iters,
        solve_seconds=time.perf_counter() - t_start,
        n_workers=n_workers,
    )


# ---------------------------------------------------------------------------
# Multi-host planning: per-host memory budgets (DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiHostPlan:
    """A partition-granular refresh plan across ``H`` hosts, each with its
    own Memory Catalog budget.

    Because the expanded DAG is co-partitioned and placement is per
    partition, the graph decomposes into disjoint per-host subgraphs
    (``MVGraph.host_slices``): each host executes its own ``Plan`` over its
    own partitions, independently feasible under *its* budget at *its*
    worker count — per-host budgets are separate knapsack constraints, the
    extra dimension of the per-slice decomposition (DESIGN.md §13). Cross-
    host constraints only appear when fault re-dispatch moves partitions,
    and re-dispatched tasks run unflagged, so they can never breach a
    surviving host's budget.

    ``host_plans[h]`` is in the *local* node ids of host ``h``'s subgraph;
    ``host_nodes[h][i]`` maps local id ``i`` back to the expanded graph.
    One host degenerates bitwise to today's single-host plan.
    """

    host_plans: tuple[Plan, ...]
    host_nodes: tuple[tuple[int, ...], ...]
    placement: tuple[int, ...]  # partition -> host
    host_budgets: tuple[float, ...]
    n_partitions: int

    @property
    def n_hosts(self) -> int:
        return len(self.host_plans)

    def host_order(self, h: int) -> tuple[int, ...]:
        """Host ``h``'s execution order in expanded node ids."""
        nodes = self.host_nodes[h]
        return tuple(nodes[i] for i in self.host_plans[h].order)

    def host_flagged(self, h: int) -> frozenset[int]:
        """Host ``h``'s flagged set in expanded node ids."""
        nodes = self.host_nodes[h]
        return frozenset(nodes[i] for i in self.host_plans[h].flagged)

    @property
    def flagged(self) -> frozenset[int]:
        """All flagged expanded node ids, across hosts."""
        out: set[int] = set()
        for h in range(self.n_hosts):
            out |= self.host_flagged(h)
        return frozenset(out)

    @property
    def score(self) -> float:
        return sum(p.score for p in self.host_plans)

    def host_of(self, expanded_id: int) -> int:
        """The host an expanded node is placed on (by its partition)."""
        return self.placement[expanded_id % self.n_partitions]


def default_placement(n_partitions: int, n_hosts: int) -> tuple[int, ...]:
    """Hash placement: partition ``p`` on host ``p % H`` (uniform keys)."""
    H = max(int(n_hosts), 1)
    return tuple(p % H for p in range(max(int(n_partitions), 1)))


def solve_multihost(
    expanded: MVGraph,
    host_budgets: Sequence[float],
    n_partitions: int,
    placement: Sequence[int] | None = None,
    flat_threshold: int = FLAT_THRESHOLD,
    **solve_kw,
) -> MultiHostPlan:
    """Per-host-budget partition-granular solve over an already-expanded
    graph (DESIGN.md §13) — ``hierarchical_plan`` with a host dimension.

    The expanded graph is sliced by ``placement`` (``MVGraph.host_slices``)
    and each host's subgraph — itself a valid ``P_h``-way expansion — gets
    its own hierarchical solve against that host's budget, so every host's
    resident set is feasible under its own budget at the configured worker
    count by ``hierarchical_plan``'s existing invariant. ``solve_kw`` obeys
    the same whitelist as ``solve_hierarchical``. With one host this *is*
    ``hierarchical_plan(expanded, host_budgets[0], P)`` — bitwise today's
    plan, exact-flat fallback included.
    """
    P = max(int(n_partitions), 1)
    budgets = tuple(float(b) for b in host_budgets)
    if not budgets:
        raise ValueError("need at least one host budget")
    unsupported = set(solve_kw) - {
        "n_workers", "max_entry_bytes", "order_solver", "order_kwargs",
        "max_iters",
    }
    if unsupported:
        raise TypeError(
            f"solve_multihost does not accept {sorted(unsupported)} "
            "(same whitelist as solve_hierarchical)"
        )
    if placement is None:
        placement = default_placement(P, len(budgets))
    placement = tuple(int(h) for h in placement)
    if len(placement) != P:
        raise ValueError(
            f"placement covers {len(placement)} partitions, expected {P}"
        )
    if placement and not (0 <= min(placement) <= max(placement) < len(budgets)):
        raise ValueError("placement names a host with no budget")
    if len(budgets) == 1:
        plan = hierarchical_plan(
            expanded, budgets[0], P, flat_threshold=flat_threshold, **solve_kw
        )
        return MultiHostPlan(
            host_plans=(plan,),
            host_nodes=(tuple(range(expanded.n)),),
            placement=placement,
            host_budgets=budgets,
            n_partitions=P,
        )
    host_plans: list[Plan] = []
    host_nodes: list[tuple[int, ...]] = []
    slices = list(expanded.host_slices(P, placement))
    # host_slices covers 0..max(placement); hosts beyond it hold nothing
    slices += [((), ())] * (len(budgets) - len(slices))
    for h, (parts, keep) in enumerate(slices):
        sub = expanded.subgraph(keep)
        if not parts:
            host_plans.append(serial_plan(sub))
        else:
            host_plans.append(
                hierarchical_plan(
                    sub, budgets[h], len(parts),
                    flat_threshold=flat_threshold, **solve_kw,
                )
            )
        host_nodes.append(tuple(keep))
    return MultiHostPlan(
        host_plans=tuple(host_plans),
        host_nodes=tuple(host_nodes),
        placement=placement,
        host_budgets=budgets,
        n_partitions=P,
    )


def solve_hierarchical(
    graph: MVGraph,
    budget: float,
    n_partitions: int,
    cost_model=None,
    shares: Sequence[float] | None = None,
    flat_threshold: int = FLAT_THRESHOLD,
    host_budgets: Sequence[float] | None = None,
    placement: Sequence[int] | None = None,
    **solve_kw,
) -> PartitionedPlan:
    """Partition-granular solve that scales to large P (DESIGN.md §8).

    Drop-in for ``solve_partitioned``: same expansion (``shares`` split,
    optional ``cost_model`` rescore), same ``PartitionedPlan`` result, but
    the plan comes from the hierarchical decomposition (``hierarchical_plan``)
    once ``n·P`` exceeds ``flat_threshold`` — per-MV benefit-curve columns
    plus a greedy outer knapsack over base-granularity windows — instead of
    the flat MKP over all ``n·P`` items. Small instances, and always
    ``P == 1``, fall back to the exact flat path and return bitwise
    identical plans.

    ``solve_kw`` must be understood by *both* paths — ``n_workers``,
    ``max_entry_bytes``, ``order_solver``, ``order_kwargs``, ``max_iters``
    — so a given call plans under one configuration regardless of which
    side of ``flat_threshold`` the instance lands on; anything else (e.g.
    a flat-only ``node_solver``) raises instead of being silently ignored
    on large instances.

    With ``host_budgets`` (DESIGN.md §13) the solve gains a host dimension
    and returns a ``MultiHostPlan`` instead: partitions are placed on hosts
    (``placement``, hash by default) and each host's resident set is planned
    feasible under its *own* budget via ``solve_multihost``. ``budget`` is
    ignored on that path — the per-host budgets are the constraints.
    """
    P = max(int(n_partitions), 1)
    unsupported = set(solve_kw) - {
        "n_workers", "max_entry_bytes", "order_solver", "order_kwargs",
        "max_iters",
    }
    if unsupported:
        raise TypeError(
            f"solve_hierarchical does not accept {sorted(unsupported)}: the "
            "hierarchical path could not honor them, so the same call would "
            "plan differently on either side of flat_threshold"
        )
    if host_budgets is not None:
        expanded, _ = graph.expand_partitions(P, shares)
        if cost_model is not None:
            from .speedup import rescore

            expanded = rescore(expanded, cost_model)
        return solve_multihost(
            expanded, host_budgets, P, placement=placement,
            flat_threshold=flat_threshold, **solve_kw,
        )
    if P == 1 or graph.n * P <= flat_threshold:
        # every supported key maps onto the flat solve too (max_iters is
        # the alternation cap on both paths)
        return solve_partitioned(
            graph, budget, P, cost_model=cost_model, shares=shares, **solve_kw
        )
    expanded, index = graph.expand_partitions(P, shares)
    if cost_model is not None:
        from .speedup import rescore

        expanded = rescore(expanded, cost_model)
    return PartitionedPlan(
        plan=hierarchical_plan(
            expanded, budget, P, flat_threshold=flat_threshold, **solve_kw
        ),
        n_partitions=P,
        index=index,
    )


def serial_plan(graph: MVGraph) -> Plan:
    """The unoptimized baseline: topological order, nothing kept in memory."""
    tau = graph.topological_order()
    return Plan(
        order=tuple(tau),
        flagged=frozenset(),
        score=0.0,
        peak_memory=0.0,
        avg_memory=0.0,
        iterations=0,
        solve_seconds=0.0,
    )
