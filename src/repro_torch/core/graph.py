"""Dependency-graph model for S/C Opt (paper §IV).

An ``MVGraph`` is a DAG whose nodes are individual materialization jobs (MV
updates in the paper; dataset/checkpoint/activation artifacts in the framework
integrations). Each node carries a size ``s_i`` (bytes the artifact occupies in
the Memory Catalog) and a speedup score ``t_i`` (estimated end-to-end seconds
saved by *flagging* the node, i.e. keeping its output in bounded memory until
its last consumer has executed).

Core semantics implemented here, exactly as defined in the paper:

* execution order ``tau``: a topological permutation of nodes; we represent it
  as ``order`` (``order[k]`` = node executed at step ``k``).
* residency: a flagged node ``j`` is resident in the Memory Catalog from its
  own execution step until the step of its **last child**
  (``lc(j) = max_{(j,k) in E} pos[k]``, or ``pos[j]`` for childless nodes).
* resident set ``V_i = {j : pos[j] <= pos[i] <= lc(j)}`` — the candidate nodes
  co-resident while node ``i`` executes (paper §V-A). These become the MKP
  capacity constraints.
* peak memory usage  = max_i  sum_{j in V_i ∩ U} s_j          (constraint)
* average memory usage = (1/n) sum_{i in U} (lc(i)-pos[i])·s_i (Opt-Order obj.)

Concurrency extension (DESIGN.md §2): under the execution engine's k-worker
discipline (in-order issue, out-of-order completion, and a window constraint —
``order[i]`` may start only once ``order[i-k]`` has completed), a flagged
node's residency is contained in steps ``[pos(j), lc(j) + k - 1]``: its last
child may still be running while up to ``k-1`` later nodes complete and admit
their outputs. Every residency/feasibility query below therefore accepts
``n_workers``; ``n_workers=1`` reduces exactly to the paper's serial
definitions.

Layer contract: this module is pure structure — node indices, byte sizes,
and score floats; it never touches real tables, cost models, or time. A
plan whose flagged set satisfies ``is_feasible(flagged, order, M, k)`` here
is guaranteed to stay within ``M`` catalog bytes under *every* interleaving
the engine can produce with ``k`` workers — planner (``core.altopt``),
engine, and simulator all trust this one accounting. Partition support
keeps the same contract over the P-way expansion: ``expand_partitions``
produces the co-partitioned graph the partition planner and
``mv.partition.partition_workload`` agree on (index layout ``v*P + p``,
shares normalized by ``normalize_shares``), and ``partition_benefit_curves``
reads per-MV marginal-benefit rankings off an expanded graph for the
hierarchical planner (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Iterable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class MVGraph:
    """Immutable DAG with per-node sizes and speedup scores."""

    n: int
    edges: tuple[tuple[int, int], ...]
    sizes: tuple[float, ...]
    scores: tuple[float, ...]
    names: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.sizes) != self.n or len(self.scores) != self.n:
            raise ValueError("sizes/scores length must equal n")
        for a, b in self.edges:
            if not (0 <= a < self.n and 0 <= b < self.n):
                raise ValueError(f"edge ({a},{b}) out of range")
            if a == b:
                raise ValueError("self-loop")
        if not self.names:
            object.__setattr__(self, "names", tuple(f"v{i}" for i in range(self.n)))
        # cycle check via Kahn
        if len(self.topological_order()) != self.n:
            raise ValueError("graph has a cycle")

    # -- adjacency ----------------------------------------------------------
    @cached_property
    def children(self) -> tuple[tuple[int, ...], ...]:
        out: list[list[int]] = [[] for _ in range(self.n)]
        for a, b in self.edges:
            out[a].append(b)
        return tuple(tuple(c) for c in out)

    @cached_property
    def parents(self) -> tuple[tuple[int, ...], ...]:
        out: list[list[int]] = [[] for _ in range(self.n)]
        for a, b in self.edges:
            out[b].append(a)
        return tuple(tuple(p) for p in out)

    @cached_property
    def roots(self) -> tuple[int, ...]:
        return tuple(i for i in range(self.n) if not self.parents[i])

    def topological_order(self) -> list[int]:
        """Kahn topological order (deterministic: lowest index first)."""
        import heapq

        indeg = [len(self.parents[i]) for i in range(self.n)]
        heap = [i for i in range(self.n) if indeg[i] == 0]
        heapq.heapify(heap)
        order: list[int] = []
        while heap:
            v = heapq.heappop(heap)
            order.append(v)
            for c in self.children[v]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(heap, c)
        return order

    # -- order helpers -------------------------------------------------------
    def is_topological(self, order: Sequence[int]) -> bool:
        if sorted(order) != list(range(self.n)):
            return False
        pos = positions(order)
        return all(pos[a] < pos[b] for a, b in self.edges)

    def last_child_pos(self, order: Sequence[int]) -> list[int]:
        """lc(i): step of i's last child; own step for childless nodes."""
        pos = positions(order)
        return [
            max((pos[c] for c in self.children[i]), default=pos[i])
            for i in range(self.n)
        ]

    def release_pos(self, order: Sequence[int], n_workers: int = 1) -> list[int]:
        """Latest step at which node i can still be catalog-resident.

        Serial (``n_workers=1``): its last child's step. With k workers the
        window discipline lets i's last child stay in flight while up to k-1
        later nodes complete, so residency extends to ``lc(i) + k - 1``.
        """
        lc = self.last_child_pos(order)
        slack = max(int(n_workers), 1) - 1
        return [min(p + slack, self.n - 1) for p in lc]

    # -- memory accounting ----------------------------------------------------
    def residency_profile(
        self, flagged: Iterable[int], order: Sequence[int], n_workers: int = 1
    ) -> list[float]:
        """Bytes of flagged data resident in the catalog at each step (worst
        case over k-worker interleavings when ``n_workers > 1``)."""
        pos = positions(order)
        rel = self.release_pos(order, n_workers)
        prof = [0.0] * self.n
        for i in set(flagged):
            for k in range(pos[i], rel[i] + 1):
                prof[k] += self.sizes[i]
        return prof

    def peak_memory(
        self, flagged: Iterable[int], order: Sequence[int], n_workers: int = 1
    ) -> float:
        """Worst-case peak catalog bytes of ``flagged`` under ``order`` —
        the left side of the paper's hard constraint ``peak <= M``."""
        prof = self.residency_profile(flagged, order, n_workers)
        return max(prof) if prof else 0.0

    def avg_memory(self, flagged: Iterable[int], order: Sequence[int]) -> float:
        """Paper Opt-Order objective: (1/n) Σ_{i∈U} (lc(i) − pos(i))·s_i."""
        pos = positions(order)
        lc = self.last_child_pos(order)
        return sum((lc[i] - pos[i]) * self.sizes[i] for i in set(flagged)) / max(
            self.n, 1
        )

    def is_feasible(
        self,
        flagged: Iterable[int],
        order: Sequence[int],
        budget: float,
        n_workers: int = 1,
    ) -> bool:
        """True iff ``flagged`` fits ``budget`` bytes at every step of
        ``order`` under the worst ``n_workers``-worker interleaving."""
        return self.peak_memory(flagged, order, n_workers) <= budget + 1e-9

    def total_score(self, flagged: Iterable[int]) -> float:
        """The S/C objective: summed speedup scores of the flagged set."""
        return sum(self.scores[i] for i in set(flagged))

    # -- resident sets (MKP constraints) --------------------------------------
    def resident_sets(
        self,
        order: Sequence[int],
        exclude: frozenset[int] = frozenset(),
        n_workers: int = 1,
    ) -> list[frozenset[int]]:
        """V_i for every step, restricted to non-excluded candidate nodes.

        Computed with a single linear scan (paper: GetConstraints is linear):
        nodes enter at their own step and leave after their release step
        (last child's step, plus the ``n_workers - 1`` window slack).
        """
        lc = self.release_pos(order, n_workers)
        leave_at: list[list[int]] = [[] for _ in range(self.n)]
        for i in range(self.n):
            if i not in exclude:
                leave_at[lc[i]].append(i)
        active: set[int] = set()
        out: list[frozenset[int]] = []
        for k, v in enumerate(order):
            if v not in exclude:
                active.add(v)
            out.append(frozenset(active))
            for i in leave_at[k]:
                active.discard(i)
        return out

    # -- partition expansion (partition-granular residency, DESIGN.md §7) -----
    def expand_partitions(
        self,
        n_partitions: int,
        shares: Sequence[float] | None = None,
    ) -> tuple["MVGraph", tuple[tuple[int, int], ...]]:
        """The P-way co-partitioned expansion of this graph: node ``v``
        becomes ``P`` nodes ``(v, p)`` at indices ``v*P + p`` with edges only
        between equal partitions (hash partitioning by a key column routes
        every operator's partition-``p`` output from its parents'
        partition-``p`` outputs). ``shares`` are the per-partition byte
        fractions (default uniform; a skewed key distribution makes them
        uneven — the same vector applies to every node because hot keys hash
        to the same partition at every operator). Scores are split like
        sizes — callers wanting latency-exact per-partition scores rescore
        via ``speedup.score_partitioned_graph``. ``P=1`` returns ``self``
        unchanged: whole-MV planning is the degenerate case.

        Returns ``(expanded graph, index)`` with ``index[i] = (node,
        partition)`` for every expanded node ``i``.
        """
        P = max(int(n_partitions), 1)
        if P == 1:
            return self, tuple((v, 0) for v in range(self.n))
        shares = normalize_shares(P, shares)
        edges = tuple(
            (a * P + p, b * P + p) for a, b in self.edges for p in range(P)
        )
        sizes = tuple(self.sizes[v] * s for v in range(self.n) for s in shares)
        scores = tuple(self.scores[v] * s for v in range(self.n) for s in shares)
        names = tuple(
            f"{self.names[v]}@p{p}" for v in range(self.n) for p in range(P)
        )
        index = tuple((v, p) for v in range(self.n) for p in range(P))
        return MVGraph(self.n * P, edges, sizes, scores, names), index

    def partition_benefit_curves(
        self, n_partitions: int
    ) -> tuple["BenefitCurve", ...]:
        """Per-MV partition benefit curves of a P-way *expanded* graph.

        ``self`` must follow the ``expand_partitions`` index layout (expanded
        node ``v * P + p`` is partition ``p`` of base node ``v``). For every
        base node the curve ranks its partitions by marginal benefit density
        (score per byte, descending, ties broken smallest-first), with
        cumulative prefix sums: pinning the curve's first ``j`` partitions is
        the "top-j column" of the hierarchical planner — it buys
        ``cum_scores[j]`` speedup at ``cum_sizes[j]`` catalog bytes. The
        density ranking makes each curve's marginal densities non-increasing
        (a concave benefit frontier), which is what lets a greedy outer
        knapsack select near-optimal columns (``mkp.greedy_column_select``).

        Returns one ``BenefitCurve`` per base node, in base-node order.
        """
        P = max(int(n_partitions), 1)
        if self.n % P != 0:
            raise ValueError(
                f"graph with {self.n} nodes is not a {P}-way expansion"
            )
        curves = []
        for v in range(self.n // P):
            ranked = sorted(
                range(P),
                key=lambda p: (
                    -(
                        self.scores[v * P + p]
                        / max(self.sizes[v * P + p], 1e-12)
                    ),
                    self.sizes[v * P + p],
                    p,
                ),
            )
            curves.append(
                BenefitCurve(
                    node=v,
                    parts=tuple(ranked),
                    sizes=tuple(self.sizes[v * P + p] for p in ranked),
                    scores=tuple(self.scores[v * P + p] for p in ranked),
                )
            )
        return tuple(curves)

    def host_slices(
        self, n_partitions: int, placement: Sequence[int]
    ) -> tuple[tuple[tuple[int, ...], tuple[int, ...]], ...]:
        """Host-wise decomposition of a P-way *expanded* graph (§13).

        ``self`` must follow the ``expand_partitions`` layout and
        ``placement[p]`` names the host partition ``p`` runs on. Because
        edges are co-partitioned, the expanded DAG is the disjoint union of
        its per-host induced subgraphs — each host's resident set is charged
        only by its own partitions, which is what makes per-host memory
        budgets *separate* knapsack constraints.

        Returns, for host ``h`` (0..max(placement)), a pair
        ``(parts, keep)``: the partitions placed on ``h`` in ascending order
        and the expanded node ids of those partitions in v-major order —
        exactly the ``expand_partitions`` layout again, so
        ``self.subgraph(keep)`` is itself a valid ``len(parts)``-way
        expansion that the hierarchical planner runs on unchanged. Hosts
        with no partitions get empty pairs.
        """
        P = max(int(n_partitions), 1)
        if self.n % P != 0:
            raise ValueError(
                f"graph with {self.n} nodes is not a {P}-way expansion"
            )
        if len(placement) != P:
            raise ValueError(
                f"placement names {len(placement)} partitions, graph has {P}"
            )
        n_base = self.n // P
        n_hosts = max(int(h) for h in placement) + 1
        out = []
        for h in range(n_hosts):
            parts = tuple(p for p in range(P) if int(placement[p]) == h)
            keep = tuple(
                v * P + p for v in range(n_base) for p in parts
            )
            out.append((parts, keep))
        return tuple(out)

    # -- misc ------------------------------------------------------------------
    def subgraph(self, keep: Sequence[int]) -> "MVGraph":
        """The induced subgraph on ``keep``, nodes renumbered to
        ``0..len(keep)-1`` in the given order."""
        remap = {v: i for i, v in enumerate(keep)}
        kset = set(keep)
        edges = tuple(
            (remap[a], remap[b]) for a, b in self.edges if a in kset and b in kset
        )
        return MVGraph(
            n=len(keep),
            edges=edges,
            sizes=tuple(self.sizes[v] for v in keep),
            scores=tuple(self.scores[v] for v in keep),
            names=tuple(self.names[v] for v in keep),
        )

    def to_networkx(self):
        import networkx as nx

        g = nx.DiGraph()
        g.add_nodes_from(range(self.n))
        g.add_edges_from(self.edges)
        return g


@dataclasses.dataclass(frozen=True)
class BenefitCurve:
    """One MV's partition benefit curve (``MVGraph.partition_benefit_curves``).

    ``parts`` are the MV's partition ids ranked by marginal benefit density
    (score/size, descending); ``sizes``/``scores`` are the per-partition
    bytes/speedup in that ranking. Pinning the first ``j`` entries is the
    MV's "top-j column": ``sum(sizes[:j])`` catalog bytes buying
    ``sum(scores[:j])`` speedup, with non-increasing marginal density in
    ``j`` — the concavity the greedy outer knapsack relies on.
    """

    node: int
    parts: tuple[int, ...]
    sizes: tuple[float, ...]
    scores: tuple[float, ...]


def normalize_shares(
    n_partitions: int, shares: Sequence[float] | None
) -> list[float]:
    """Validated, sum-1 per-partition byte shares (None → uniform). The one
    policy both expansions — ``MVGraph.expand_partitions`` and
    ``mv.partition.partition_workload`` — must agree on."""
    P = max(int(n_partitions), 1)
    if shares is None:
        return [1.0 / P] * P
    if len(shares) != P:
        raise ValueError(f"need {P} shares, got {len(shares)}")
    shares = [float(s) for s in shares]
    if any(s < 0 for s in shares) or sum(shares) <= 0:
        raise ValueError("shares must be non-negative with a positive sum")
    total = sum(shares)
    return [s / total for s in shares]


def positions(order: Sequence[int]) -> list[int]:
    """pos[i] = step at which node i executes."""
    pos = [0] * len(order)
    for k, v in enumerate(order):
        pos[v] = k
    return pos


def from_parent_lists(
    parents: Mapping[int, Sequence[int]] | Sequence[Sequence[int]],
    sizes: Sequence[float],
    scores: Sequence[float],
    names: Sequence[str] = (),
) -> MVGraph:
    """Build an ``MVGraph`` from per-node parent lists (the shape workload
    definitions naturally carry) instead of an explicit edge list."""
    n = len(sizes)
    if isinstance(parents, Mapping):
        plist = [tuple(parents.get(i, ())) for i in range(n)]
    else:
        plist = [tuple(p) for p in parents]
    edges = tuple((p, i) for i in range(n) for p in plist[i])
    return MVGraph(n, edges, tuple(sizes), tuple(scores), tuple(names))
