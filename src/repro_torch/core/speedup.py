"""Speedup-score model (paper §IV, "Speedup Scores").

    t_i =   Σ_{(v_i,v_j)∈E} [ read(v_i | disk) − read(v_i | memory) ]
          + [ create(v_i | disk) − create(v_i | memory) ]

The first term is saved once per child (each consumer reads the parent from
the catalog instead of storage); the second is the write that moves off the
critical path (materialization happens in the background, Fig. 6 t2..t4).

The cost model is bandwidth/latency based, with defaults matching the paper's
experiment environment (519.8 MB/s disk read, 358.9 MB/s disk write, 175 µs
read latency). Memory bandwidth defaults to a conservative DRAM figure. All
sizes are bytes, all times seconds.

Layer contract: this module is the *only* place byte counts become seconds.
It turns structural facts (sizes, child counts, update churn) into the
per-node speedup scores and update-round byte/compute profiles that the
planner (``core.altopt``), the simulator, and the per-round scenario
drivers consume — it never looks at real data, so the same scores are valid
for both the discrete-event and the real-executor backends. Scoring a graph
(``score_graph`` / ``rescore`` / ``score_partitioned_graph``) must be
deterministic in its inputs: plans, and therefore stored bytes, depend on
reproducible scores.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .graph import MVGraph


@dataclasses.dataclass(frozen=True)
class CostModel:
    disk_read_bw: float = 519.8e6
    disk_write_bw: float = 358.9e6
    mem_read_bw: float = 10e9
    mem_write_bw: float = 10e9
    disk_latency: float = 175e-6
    # large sequential base-table scans sustain full bandwidth even when the
    # many-file intermediate I/O path is derated (0 = same as disk_read_bw)
    seq_read_bw: float = 0.0
    # fraction of the background write that still interferes with compute
    write_interference: float = 0.0

    def read_disk(self, size: float) -> float:
        return self.disk_latency + size / self.disk_read_bw

    def read_base(self, size: float) -> float:
        bw = self.seq_read_bw or self.disk_read_bw
        return self.disk_latency + size / bw

    def read_mem(self, size: float) -> float:
        return size / self.mem_read_bw

    def write_disk(self, size: float) -> float:
        return size / self.disk_write_bw

    def write_mem(self, size: float) -> float:
        return size / self.mem_write_bw

    def speedup_score(self, size: float, n_children: int) -> float:
        per_child = self.read_disk(size) - self.read_mem(size)
        create = self.write_disk(size) - self.write_mem(size)
        create *= 1.0 - self.write_interference
        return max(0.0, n_children * per_child + create)


PAPER_COST_MODEL = CostModel()

# Effective NFS throughput *during MV refresh*: the paper's 519.8/358.9 MB/s
# are sequential microbenchmarks; concurrent multi-file Parquet writes +
# metadata traffic over NFS sustain far less. This derated model is what makes
# the simulator consistent with the paper's own wall-clock anchors (Table V:
# 1528s no-opt, ~1.6x S/C at 100GB with the 1.6% catalog) — see DESIGN.md §4.
EFFECTIVE_NFS_COST_MODEL = CostModel(
    disk_read_bw=100e6,
    disk_write_bw=66e6,
    disk_latency=175e-6,
    seq_read_bw=519.8e6,   # base-table scans stay sequential-fast
)


def score_graph(
    n: int,
    edges: Sequence[tuple[int, int]],
    sizes: Sequence[float],
    cost_model: CostModel = PAPER_COST_MODEL,
    names: Sequence[str] = (),
) -> MVGraph:
    """Build an ``MVGraph`` with speedup scores derived from the cost model.

    ``t_i = n_children(i) · [read_disk(s_i) − read_mem(s_i)] +
    (1 − write_interference) · [write_disk(s_i) − write_mem(s_i)]``,
    clamped at 0 — the seconds flagging node ``i`` saves end to end.
    ``edges`` are ``(parent, child)`` pairs; ``sizes`` are output bytes.
    """
    n_children = [0] * n
    for a, _ in edges:
        n_children[a] += 1
    scores = tuple(
        cost_model.speedup_score(sizes[i], n_children[i]) for i in range(n)
    )
    return MVGraph(
        n=n,
        edges=tuple(edges),
        sizes=tuple(float(s) for s in sizes),
        scores=scores,
        names=tuple(names),
    )


def rescore(graph: MVGraph, cost_model: CostModel) -> MVGraph:
    """Same structure and sizes, speedup scores recomputed under
    ``cost_model`` — use when a graph built for one storage tier is planned
    against another (or after ``expand_partitions`` split sizes)."""
    return score_graph(graph.n, graph.edges, graph.sizes, cost_model, graph.names)


# ---------------------------------------------------------------------------
# Partition-granular scoring (fractional residency, DESIGN.md §7)
# ---------------------------------------------------------------------------

def partition_shares(
    n_partitions: int, skew: float = 0.0, seed: int = 0
) -> tuple[float, ...]:
    """Modeled per-partition byte shares of a hash-partitioned table:
    Zipf(``skew``) over partitions, deterministically shuffled by ``seed``
    (``skew=0`` → uniform). A skewed key distribution concentrates bytes in
    the partitions its hot keys hash to; the same share vector applies to
    every node of a co-partitioned pipeline."""
    import random

    P = max(int(n_partitions), 1)
    w = [1.0 / (i + 1) ** skew for i in range(P)]
    rng = random.Random(seed)
    rng.shuffle(w)
    total = sum(w)
    return tuple(x / total for x in w)


def score_partitioned_graph(
    n: int,
    edges: Sequence[tuple[int, int]],
    sizes: Sequence[float],
    n_partitions: int,
    cost_model: CostModel = PAPER_COST_MODEL,
    names: Sequence[str] = (),
    shares: Sequence[float] | None = None,
) -> tuple[MVGraph, tuple[tuple[int, int], ...]]:
    """Speedup-scored P-way co-partitioned MVGraph.

    Each node ``v`` becomes ``P`` independently flaggable nodes ``(v, p)``
    sized by ``shares`` (default uniform), each scored with the full cost
    model — per-partition reads pay their own seek latency, so P-way
    partitioning is *not* free in the objective. Flagging a subset of a
    node's partitions buys that subset's read savings at that subset's byte
    cost: the objective now prices fractional residency, with ``P=1``
    reducing bit-for-bit to ``score_graph``. Returns the expanded graph and
    the ``(node, partition)`` index of every expanded node."""
    base = score_graph(n, edges, sizes, cost_model, names)
    P = max(int(n_partitions), 1)
    if P == 1:
        return base, tuple((v, 0) for v in range(n))
    expanded, index = base.expand_partitions(P, shares)
    return rescore(expanded, cost_model), index


# ---------------------------------------------------------------------------
# Update-mode scoring (full vs incremental refresh rounds)
# ---------------------------------------------------------------------------
#
# The paper's experiment matrix runs every workload under both *full* and
# *incremental* updates. A refresh round moves very different byte counts in
# the two modes, so the speedup scores — and with them which nodes are worth
# flagging — change with the active update mode: incremental refresh shrinks
# the short-circuitable bytes to each node's *update* (its insert-only delta
# for delta-propagating operators, its full rewrite for merge/fallback
# operators), while historical re-reads (a join's full build side, an
# aggregate's previous state) are charged like base-table scans: identical
# under every method and never catalog-resident.

STATIC = "static"        # no change this round; node is skipped entirely
APPENDED = "appended"    # new output = old output ++ delta (insert-only)
DELTA = "delta"          # new output = apply_delta(old, Δ±): a Z-set delta
#                          carrying retractions (updates/deletes), spliced
#                          by rid rather than appended
REPLACED = "replaced"    # full rewrite; children must re-read everything

CHANGED = (APPENDED, DELTA)  # statuses whose delta propagates to children


@dataclasses.dataclass(frozen=True)
class UpdateRound:
    """Per-node refresh profile for one update round (round_idx >= 1).

    ``update_bytes`` is what a child pulls from the parent this round (and
    what a flagged entry occupies in the Memory Catalog, and what the node
    writes); ``extra_read`` is the non-short-circuitable disk traffic
    (historical re-reads); ``compute`` is this round's compute seconds;
    ``full_sizes`` the node's full size after the round.
    """

    statuses: tuple[str, ...]
    update_bytes: tuple[float, ...]
    extra_read: tuple[float, ...]
    compute: tuple[float, ...]
    full_sizes: tuple[float, ...]
    lineage: tuple[float, ...]  # fraction of content tracing to ingesting scans


def propagate_update(
    ops: Sequence[str],
    parents: Sequence[Sequence[int]],
    sizes: Sequence[float],
    computes: Sequence[float],
    base_reads: Sequence[float],
    ingest: frozenset[int] | set[int],
    frac: float,
    round_idx: int = 1,
    mode: str = "incremental",
    update_frac: float = 0.0,
    delete_frac: float = 0.0,
    join_fallback_rate: float = 1.0,
    force_full: frozenset[int] | set[int] = frozenset(),
) -> UpdateRound:
    """Propagate a Z-set update round through the DAG (DESIGN.md §5-6).

    Linear growth model: each ingesting scan appends ``frac`` of its initial
    rows per round, rewrites ``update_frac`` of its live rows (a retraction
    plus an insertion — two delta rows), and retracts ``delete_frac`` (one
    tombstone row); retraction bytes count toward update I/O and incremental
    compute. A node's delta share is its *ingest lineage* ``phi(v)`` — the
    input-byte-weighted fraction of its content tracing to ingesting scans.
    Status propagation mirrors the real delta operators:
    FILTER/PROJECT/MAP/UNION pass weighted deltas through (APPENDED when
    insert-only, DELTA once retractions are in play), JOIN joins the left
    delta against its full (re-read) right sides plus partial-fallback
    corrections for right-side retractions, AGG merges signed partial
    aggregates (its own output is rewritten, so children re-read it fully),
    and any child of a replaced node recomputes fully. ``mode="full"``
    forces every non-scan node to REPLACED — the full-refresh baseline
    round.

    ``join_fallback_rate`` calibrates the JOIN correction-cost term with the
    *observed* partial-fallback rate (the fraction of affected right-side
    keys that actually matched surviving old-left rows in previous rounds,
    ``RoundReport.fallback_stats``); the default 1.0 is the uncalibrated
    worst case — every affected key corrects. Statuses are rate-independent:
    a round that *could* emit corrections stays DELTA even at rate 0.

    ``force_full`` marks individual non-scan nodes for full recomputation
    this round regardless of the global mode — the per-view adaptive
    chooser (``choose_refresh_modes``) feeds its decisions through here so
    the planner prices exactly the refresh the engine will run. A forced
    node is REPLACED and its children recompute fully, same as under
    ``mode="full"``.
    """
    n = len(ops)
    if round_idx < 1:
        raise ValueError("update rounds start at 1 (round 0 is the build)")
    churn = frac + 2.0 * update_frac + delete_frac   # delta rows incl. retractions
    growth = frac - delete_frac                      # net size drift per round
    touch = frac + update_frac + delete_frac         # base rows visited
    retracting = (update_frac > 0.0) or (delete_frac > 0.0)
    topo: Sequence[int] = range(n)
    if any(p >= v for v in range(n) for p in parents[v]):
        from .graph import from_parent_lists

        topo = from_parent_lists(
            [tuple(p) for p in parents], list(sizes), [0.0] * n
        ).topological_order()
    phi = [0.0] * n
    for v in topo:
        ps = parents[v]
        if not ps:
            phi[v] = 1.0 if v in ingest else 0.0
        else:
            in_bytes = sum(sizes[p] for p in ps)
            phi[v] = (
                sum(phi[p] * sizes[p] for p in ps) / in_bytes if in_bytes else 0.0
            )

    def full_at(v: int, r: int) -> float:
        # deletes shrink content (growth < 0); clamp well above zero so byte
        # ratios stay meaningful even for delete-heavy long scenarios
        return sizes[v] * max(1.0 + r * growth * phi[v], 0.05)

    # rid lineage: AGG outputs drop the row id, and a UNION over any rid-less
    # input loses the canonical order its append rule needs (the engine
    # recomputes such unions fully — mirror that here)
    has_rid = [True] * n
    for v in topo:
        ps = parents[v]
        if ops[v] == "AGG":
            has_rid[v] = False
        elif ops[v] == "JOIN" and ps:
            has_rid[v] = has_rid[ps[0]]
        elif ps:
            has_rid[v] = all(has_rid[p] for p in ps)

    statuses = [STATIC] * n
    update = [0.0] * n
    extra = [0.0] * n
    comp = [0.0] * n
    for v in topo:
        ps = parents[v]
        delta_v = sizes[v] * churn * phi[v]
        if not ps:  # SCAN: ingestion lands a delta part in every mode
            if phi[v] == 0.0:
                continue
            statuses[v] = DELTA if retracting else APPENDED
            update[v] = delta_v
            extra[v] = base_reads[v] * touch  # scans only the touched base rows
            comp[v] = computes[v] * churn
            continue
        if phi[v] == 0.0:  # untouched subtree: nothing to refresh
            continue
        in0 = sum(sizes[p] for p in ps) or 1.0
        delta_in = sum(update[p] for p in ps if statuses[p] in CHANGED)
        any_retract = any(statuses[p] == DELTA for p in ps)
        forced_full = (
            mode == "full"
            or v in force_full
            or any(statuses[p] == REPLACED for p in ps)
            or (ops[v] == "UNION" and len(ps) >= 2
                and not all(has_rid[p] for p in ps))
        )
        if forced_full:
            statuses[v] = REPLACED
            update[v] = full_at(v, round_idx)
            # non-replaced parents deliver only their update on the edge;
            # the rest of their (full) content is a historical re-read
            # (clamped: heavy churn can make a parent's delta exceed its
            # full size, and modeled bytes must never go negative)
            extra[v] = sum(
                max(full_at(p, round_idx) - update[p], 0.0)
                for p in ps
                if statuses[p] != REPLACED
            )
            comp[v] = computes[v] * max(
                1.0 + round_idx * growth * phi[v], 0.05
            )
        elif ops[v] == "AGG":
            # mergeable (signed) partial aggregates: read input deltas + own
            # previous output, write the merged (full) output; children
            # re-read fully
            statuses[v] = REPLACED
            update[v] = full_at(v, round_idx)
            extra[v] = full_at(v, round_idx - 1)  # previous aggregate state
            comp[v] = computes[v] * (delta_in / in0) + computes[v] * (
                sizes[v] / in0
            )
        elif ops[v] == "JOIN":
            # delta rule: join the left delta against full right sides
            # (re-read to rebuild the probe index). Right-side retractions
            # change first-occurrence matches: the partial fallback re-joins
            # only the affected old-left rows, so charge correction bytes
            # proportional to each changed right side's delta share. A right
            # delta that introduces new keys at runtime triggers the same
            # partial fallback — the one data-dependent case this analytic
            # model cannot see.
            left, rights = ps[0], ps[1:]
            dleft = update[left] if statuses[left] in CHANGED else 0.0
            raw_corr = sum(
                update[p] / max(full_at(p, round_idx), 1.0)
                for p in rights
                if statuses[p] == DELTA
            )
            corr = max(min(join_fallback_rate, 1.0), 0.0) * raw_corr
            statuses[v] = DELTA if (
                statuses[left] == DELTA or raw_corr > 0.0
            ) else APPENDED
            update[v] = sizes[v] * (
                dleft / max(sizes[left], 1.0) + min(corr, 1.0)
            )
            r_full = sum(full_at(p, round_idx) for p in rights)
            extra[v] = sum(
                max(full_at(p, round_idx) - update[p], 0.0) for p in rights
            )
            comp[v] = computes[v] * ((dleft + r_full) / in0)
        else:  # FILTER / PROJECT / MAP / UNION: pure delta pass-through
            statuses[v] = DELTA if any_retract else APPENDED
            update[v] = sizes[v] * (delta_in / in0)
            comp[v] = computes[v] * (delta_in / in0)
    return UpdateRound(
        statuses=tuple(statuses),
        update_bytes=tuple(update),
        extra_read=tuple(extra),
        compute=tuple(comp),
        full_sizes=tuple(full_at(v, round_idx) for v in range(n)),
        lineage=tuple(phi),
    )


def choose_refresh_modes(
    ops: Sequence[str],
    parents: Sequence[Sequence[int]],
    sizes: Sequence[float],
    computes: Sequence[float],
    base_reads: Sequence[float],
    ingest: frozenset[int] | set[int],
    frac: float,
    cost_model: CostModel,
    round_idx: int = 1,
    update_frac: float = 0.0,
    delete_frac: float = 0.0,
    join_fallback_rate: float = 1.0,
    margin: float = 0.9,
) -> frozenset[int]:
    """Per-view full-vs-incremental choice from modeled round costs
    (Enzyme-style adaptive maintenance, DESIGN.md §11).

    For every node an incremental round would refresh by delta, compare the
    modeled cost of its delta refresh (read parent updates + historical
    re-reads + incremental compute + write the delta — plus, for a JOIN
    expecting partial-fallback corrections, the old-left gather the runtime
    fallback pays) against the cost of recomputing it fully. Nodes where
    full is cheaper than ``margin`` × incremental are returned for
    ``propagate_update(force_full=...)`` / the engine's per-round force
    set. ``margin < 1`` is hysteresis: incremental keeps the benefit of the
    doubt, so decisions do not flip on modeling noise.

    ``join_fallback_rate`` is the calibrated (EWMA) observed fallback rate —
    the signal that makes this adaptive: a churn spike raises the JOIN
    correction terms, full recompute wins for a few rounds, and as the EWMA
    decays the node returns to incremental. Decisions are performance-only:
    both refresh paths are bitwise-identical by the engine's equivalence
    contract, so a wrong choice costs time, never correctness.
    """
    kw = dict(
        round_idx=round_idx, update_frac=update_frac,
        delete_frac=delete_frac, join_fallback_rate=join_fallback_rate,
    )
    inc = propagate_update(
        ops, parents, sizes, computes, base_reads, ingest, frac,
        mode="incremental", **kw,
    )
    full = propagate_update(
        ops, parents, sizes, computes, base_reads, ingest, frac,
        mode="full", **kw,
    )
    cm = cost_model
    forced: set[int] = set()
    for v in range(len(ops)):
        ps = parents[v]
        if not ps or inc.statuses[v] not in CHANGED:
            continue  # scans ingest identically; STATIC/REPLACED have no choice
        inc_cost = (
            cm.read_disk(sum(inc.update_bytes[p] for p in ps))
            + cm.read_base(inc.extra_read[v])
            + inc.compute[v]
            + cm.write_disk(inc.update_bytes[v])
        )
        if ops[v] == "JOIN" and len(ps) >= 2:
            left, rights = ps[0], ps[1:]
            corr = max(min(join_fallback_rate, 1.0), 0.0) * sum(
                inc.update_bytes[p] / max(inc.full_sizes[p], 1.0)
                for p in rights
                if inc.statuses[p] == DELTA
            )
            if corr > 0.0:
                # the runtime partial fallback re-reads the old left content
                # once (memoized) to re-join affected rows
                inc_cost += cm.read_disk(inc.full_sizes[left])
        full_cost = (
            cm.read_disk(sum(full.update_bytes[p] for p in ps))
            + cm.read_base(full.extra_read[v])
            + full.compute[v]
            + cm.write_disk(full.update_bytes[v])
        )
        if full_cost < margin * inc_cost:
            forced.add(v)
    return frozenset(forced)
