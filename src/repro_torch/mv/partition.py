"""Hash-partitioned MVs: partition-granular storage, planning, and refresh
(DESIGN.md §7).

S/C's planner trades memory-seconds for short-circuited I/O at whole-MV
granularity; this module applies the same objective *within* an MV. Every
table is split P ways by a deterministic hash of its ``key`` column:

* ``partition_table`` — row-stable P-way split (rows keep their relative
  order, hence their canonical rid order, inside each partition);
* co-partitioned execution — because every operator either preserves the
  key column (FILTER / PROJECT / MAP / UNION), is keyed on it (AGG), or is
  driven by it (JOIN probes equal keys), partition ``p`` of a node's output
  is a function of partition ``p`` of its inputs alone. Running the
  *unchanged* operator per partition and concatenating the outputs in
  canonical order is bitwise-identical to unpartitioned execution;
* delta routing — a Z-set delta row routes to the partition its key hashes
  to (a retraction carries the old payload, so it lands in the partition
  holding its victim; an UPDATE that moves a key emits a retraction to the
  old partition and an insertion to the new one). A refresh round therefore
  touches only *dirty* partitions, and ``run_partitioned_scenario`` prunes
  clean ones before dispatch;
* partition-granular planning — ``partition_workload`` expands a Workload
  into P co-partitioned nodes per MV, so the existing planner
  (``altopt.solve`` over the expanded view graph) chooses *which partitions
  of which MV* to pin: an MV too large to flag whole contributes whichever
  partitions fit the budget. ``P=1`` reduces to the whole-MV system
  everywhere;
* partition-parallel refresh — the expanded nodes of one MV share no
  edges, so ``ScheduleCore`` dispatches them as independent ``(mv,
  partition)`` tasks and a single wide MV refreshes data-parallel across
  the engine's k workers.

The counterpart of ``repro.mv.partition`` on PyTorch. The P-way split runs
through the data plane: on the card one ``pid_hist`` kernel launch gives
every row's partition and the partition sizes, a stable sort of the pids
gives the grouping permutation, and the sizes cross to the host once. Each
partition is a zero-copy slice of the one grouped tensor per column, so
the slices keep that tensor alive on the card while the Memory Catalog
charges each partition only its own bytes — the reference's numpy views
behave the same way.

Canonical reassembly order: stable sort by ``rid`` when the table carries
one (the row order every rid-carrying full recompute produces), else by
``key`` (AGG outputs and their descendants are key-ordered with unique
keys; key-only tables have no payload beyond the key) — so
``concat_partitions(partitioned outputs) == unpartitioned output`` bitwise.

Layer contract: partitioning changes *where bytes live and when they are
refreshed*, never *what is computed* — every partitioned scenario's
reassembled output must be bitwise identical to the unpartitioned full
recompute (``verify_partitioned_equivalence``), every per-round plan must
stay budget-feasible under every k-worker interleaving (inherited from
``core.altopt``'s plan contract over the expanded graph), and ``P=1`` must
be byte-for-byte the whole-MV system in planning, storage, and execution.
Per-round planning at high P goes through ``hierarchical_round_solver``
(DESIGN.md §8) so those guarantees hold without putting an O(n·P)-item
MKP on the refresh critical path.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import threading
from typing import Sequence

import torch

from ..core.graph import normalize_shares
from ..core.speedup import CostModel
from . import dataplane
from . import tableops as T
from .storage import DiskStore, PARTITION_SEP, partition_entry_name
from .workloads import MVNode, UpdateSpec, Workload

__all__ = [
    "partition_of",
    "partition_table",
    "dirty_partitions",
    "concat_partitions",
    "canonical_order",
    "PartitionMap",
    "partition_workload",
    "hierarchical_round_solver",
    "expand_update_spec",
    "partition_static_fn",
    "run_partitioned_scenario",
    "verify_partitioned_equivalence",
    "partition_entry_name",
    "PARTITION_SEP",
]


# ---------------------------------------------------------------------------
# Deterministic hash partitioning
# ---------------------------------------------------------------------------

def _hash64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer — deterministic across runs and platforms (no
    Python hash randomization, no dtype-width surprises). Dispatches through
    the data plane (the ``hash64`` kernel on the card, its plain version on
    the CPU)."""
    return dataplane.hash64(keys)


def partition_of(keys: torch.Tensor, n_partitions: int) -> torch.Tensor:
    """Partition id of each key (0 when P=1)."""
    return dataplane.partition_ids(keys, n_partitions)


def partition_table(
    table: T.Table, n_partitions: int, key_col: str = "key"
) -> list[T.Table]:
    """Deterministic P-way hash split by ``key_col``; row order (and with it
    canonical rid order) is preserved within every partition. Routes plain
    content and Z-set deltas alike — each delta row goes to the partition
    its own key hashes to.

    One fused hash+histogram+grouping pass through the data plane, then one
    gather per column; each partition is a zero-copy slice view of the
    grouped arrays (bitwise-identical rows to the old per-partition
    ``nonzero(pid == p)`` gathers, without the P passes)."""
    P = max(int(n_partitions), 1)
    if P == 1:
        return [dict(table)]
    if key_col not in table:
        raise ValueError(f"partitioning needs a {key_col!r} column")
    order, counts = dataplane.partition_index(table[key_col], P)
    offsets = [0, *itertools.accumulate(counts.tolist())]  # one host sync
    grouped = {k: v[order] for k, v in table.items()}
    return [
        {k: v[offsets[p]:offsets[p + 1]] for k, v in grouped.items()}
        for p in range(P)
    ]


def dirty_partitions(delta: T.Table, n_partitions: int) -> list[int]:
    """Partitions a Z-set delta routes rows to — the only partitions a
    refresh round touches."""
    if not delta or T.n_rows(delta) == 0:
        return []
    return torch.unique(partition_of(delta["key"], n_partitions),
                        sorted=True).tolist()


def canonical_order(table: T.Table) -> T.Table:
    """The canonical row order partition reassembly restores: stable by rid
    (the order every rid-carrying operator output already has), else stable
    by key (AGG-derived tables)."""
    col = "rid" if "rid" in table else ("key" if "key" in table else None)
    if col is None or T.n_rows(table) == 0:
        return dict(table)
    order = torch.sort(table[col], stable=True).indices
    return {k: v[order] for k, v in table.items()}


def concat_partitions(parts: Sequence[T.Table]) -> T.Table:
    """Reassemble partition outputs into the unpartitioned table: plain
    concatenation restored to canonical order — bitwise-identical to
    unpartitioned execution (module docstring)."""
    parts = list(parts)
    if not parts:
        raise ValueError("concat_partitions needs at least one partition")
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return canonical_order(out)


# ---------------------------------------------------------------------------
# Workload expansion: one node per (mv, partition)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """Index bookkeeping of a P-way expanded workload: expanded node
    ``v * P + p`` is partition ``p`` of original node ``v``."""

    base_names: tuple[str, ...]
    n_partitions: int

    def expanded_index(self, v: int, p: int) -> int:
        return v * self.n_partitions + p

    def base_of(self, idx: int) -> tuple[int, int]:
        """(original node, partition) of an expanded node index."""
        return divmod(idx, self.n_partitions)

    def partition_names(self, v: int) -> list[str]:
        return [
            partition_entry_name(self.base_names[v], p)
            for p in range(self.n_partitions)
        ]


class _ScanRouter:
    """Shares one generation + hash-route of a scan's output across all of
    its P partition nodes (and the dirty-partition pruner): the routed split
    is computed once per (round, churn-spec) and memoized for the current
    round, so a P-way scan costs one delta replay and one hash pass instead
    of P. Thread-safe — partition nodes of one scan execute on different
    workers."""

    def __init__(self, orig_fn, orig_delta, P: int):
        self._fn = orig_fn
        self._delta = orig_delta
        self.P = P
        self._lock = threading.Lock()
        self._key = None
        self._parts: list[T.Table] | None = None

    @staticmethod
    def _spec_key(spec) -> tuple:
        if isinstance(spec, UpdateSpec):
            return (spec.ingest_frac, spec.update_frac, spec.delete_frac)
        return (float(spec), 0.0, 0.0)

    def _routed(self, key, produce) -> list[T.Table]:
        with self._lock:
            if self._key != key:
                self._parts = partition_table(produce(), self.P)
                self._key = key
            return self._parts

    def initial(self, inputs) -> list[T.Table]:
        return self._routed(("fn",), lambda: self._fn(inputs))

    def delta(self, round_idx: int, spec) -> list[T.Table]:
        return self._routed(
            ("delta", round_idx, self._spec_key(spec)),
            lambda: self._delta(round_idx, spec),
        )


def _scan_fn(router: _ScanRouter, p: int):
    return lambda inputs: router.initial(inputs)[p]


def _scan_delta_fn(router: _ScanRouter, p: int):
    def delta_fn(round_idx, spec=0.1):
        return router.delta(round_idx, spec)[p]

    return delta_fn


def partition_workload(
    workload: Workload,
    n_partitions: int,
    shares: Sequence[float] | None = None,
) -> tuple[Workload, PartitionMap]:
    """The P-way co-partitioned expansion of a workload.

    Node ``v`` becomes ``P`` nodes named ``{name}@p{p}`` whose parents are
    exactly the same partition of ``v``'s parents. SCAN compute / delta
    functions are wrapped to emit their partition's rows (the original
    function stays the source of truth, so the union over partitions is the
    unpartitioned table by construction); non-scan operators run unchanged
    on per-partition inputs. Modeled sizes, compute, and base reads split by
    ``shares`` (default uniform — pass ``core.speedup.partition_shares``
    output to model a skewed key distribution). ``P=1`` keeps names and
    structure identical to the input workload."""
    P = max(int(n_partitions), 1)
    pmap = PartitionMap(
        base_names=tuple(n.name for n in workload.nodes), n_partitions=P
    )
    if P == 1:
        return workload, pmap
    shares = normalize_shares(P, shares)
    nodes: list[MVNode] = []
    for v, n in enumerate(workload.nodes):
        router = (
            _ScanRouter(n.fn, n.delta_fn, P)
            if not n.parents and (n.fn is not None or n.delta_fn is not None)
            else None
        )
        for p, share in enumerate(shares):
            if not n.parents:
                fn = _scan_fn(router, p) if n.fn is not None else None
                dfn = (
                    _scan_delta_fn(router, p)
                    if n.delta_fn is not None
                    else None
                )
            else:
                fn, dfn = n.fn, None
            nodes.append(
                MVNode(
                    name=partition_entry_name(n.name, p),
                    parents=tuple(pa * P + p for pa in n.parents),
                    op=n.op,
                    size=n.size * share,
                    compute=n.compute * share,
                    fn=fn,
                    base_read=n.base_read * share,
                    delta_fn=dfn,
                )
            )
    meta = dict(workload.meta)
    meta["partition"] = dict(
        n_partitions=P, base=workload.name, shares=tuple(shares)
    )
    return Workload(f"{workload.name}@P{P}", nodes, meta), pmap


def expand_update_spec(spec: UpdateSpec, pmap: PartitionMap) -> UpdateSpec:
    """The spec's ``ingest`` set remapped onto expanded node indices (every
    partition of an ingesting scan ingests)."""
    if spec.ingest is None:
        return spec
    P = pmap.n_partitions
    ingest = tuple(
        pmap.expanded_index(v, p) for v in spec.ingest for p in range(P)
    )
    return dataclasses.replace(spec, ingest=ingest)


# ---------------------------------------------------------------------------
# Partition-granular scenarios (dirty-partition pruning)
# ---------------------------------------------------------------------------

def partition_static_fn(
    workload: Workload, pwl: Workload, pmap: PartitionMap, spec: UpdateSpec
):
    """Per-round clean-partition pruner for ``run_scenario``.

    Routes each ingesting scan's round delta to its partitions once
    (deterministic replay through the expanded scans' shared ``_ScanRouter``
    memo, so the engine's own dispatch reuses the split) and marks every
    partition that receives no rows STATIC, then propagates down the
    co-partitioned DAG: partition ``p`` of a node is clean iff partition
    ``p`` of every parent is. Clean partitions are skipped before dispatch —
    their stored content is already exact — which is what makes a skewed
    update (hot keys hashing to few partitions) cheap at high P."""
    P = pmap.n_partitions
    ingest = spec.resolve_ingest(workload)

    def static_fn(round_idx: int, view_static: frozenset) -> frozenset:
        if round_idx == 0 or P == 1 or spec.mode != "incremental":
            return frozenset()
        static = set(view_static)
        for v, node in enumerate(workload.nodes):
            if node.parents or v not in ingest or node.delta_fn is None:
                continue
            static.update(
                pmap.expanded_index(v, p)
                for p in range(P)
                if T.n_rows(
                    pwl.nodes[pmap.expanded_index(v, p)].delta_fn(
                        round_idx, spec
                    )
                ) == 0
            )
        for v, node in enumerate(workload.nodes):
            if not node.parents:
                continue
            for p in range(P):
                if all(
                    pmap.expanded_index(q, p) in static for q in node.parents
                ):
                    static.add(pmap.expanded_index(v, p))
        return frozenset(static - set(view_static))

    return static_fn


@dataclasses.dataclass
class PartitionedScenarioReport:
    """``run_partitioned_scenario`` result: the scenario report over the
    expanded workload, plus the expansion itself for index/name mapping."""

    report: "object"  # incremental.ScenarioReport
    workload: Workload  # the expanded workload that executed
    pmap: PartitionMap

    @property
    def rounds(self):
        return self.report.rounds


def hierarchical_round_solver(n_partitions: int, **hier_kw):
    """Per-round planner hook solving at partition granularity with the
    hierarchical decomposition (DESIGN.md §8).

    Returns a ``solve_fn(graph, budget, n_workers) -> Plan`` suitable for
    ``run_scenario``/``simulate_scenario``: the round's view graph is
    already the P-way expansion (one node per ``(mv, partition)``), so
    ``core.altopt.hierarchical_plan`` runs directly on it — per-MV benefit
    curves, greedy column selection plus per-slice exact MKPs, partition-
    major order. Small rounds (``n·P`` at or below the flat threshold, and
    always ``P=1``) fall back to the flat exact solve, bitwise identical to
    the default planner. ``hier_kw`` forwards to ``hierarchical_plan``
    (``max_entry_bytes``, ``order_solver``, ``flat_threshold``, ...)."""
    from ..core.altopt import hierarchical_plan

    def solve_fn(graph, budget, n_workers):
        return hierarchical_plan(
            graph, budget, n_partitions, n_workers=n_workers, **hier_kw
        )

    return solve_fn


def run_partitioned_scenario(
    workload: Workload,
    n_partitions: int,
    store: DiskStore,
    budget_bytes: float,
    spec: UpdateSpec,
    cost_model: CostModel,
    shares: Sequence[float] | None = None,
    planner: str = "auto",
    **run_kw,
) -> PartitionedScenarioReport:
    """Execute a multi-round refresh scenario at partition granularity.

    The workload is expanded P ways and driven through the ordinary
    ``incremental.run_scenario``: per-round plans are solved over the
    expanded view graph (partition-granular residency), ``ScheduleCore``
    dispatches ``(mv, partition)`` tasks data-parallel across the engine's
    workers, storage holds per-partition part-file groups, and clean
    partitions are pruned per round. ``P=1`` is byte-for-byte the
    unpartitioned scenario.

    ``planner`` picks the per-round solver: ``"auto"`` (the default) uses
    the hierarchical partitioned planner, which itself falls back to the
    flat exact solve below the ``n·P`` threshold — so small scenarios stay
    bitwise identical to ``planner="flat"`` while high-P rounds plan in
    milliseconds; ``"flat"`` forces the flat ``altopt.solve`` every round;
    ``"hierarchical"`` forces the decomposition even on small rounds."""
    from .incremental import run_scenario

    pwl, pmap = partition_workload(workload, n_partitions, shares)
    if planner == "flat":
        solve_fn = None
    elif planner == "auto":
        solve_fn = hierarchical_round_solver(pmap.n_partitions)
    elif planner == "hierarchical":
        solve_fn = hierarchical_round_solver(pmap.n_partitions, flat_threshold=0)
    else:
        raise ValueError(f"unknown planner {planner!r}")
    rep = run_scenario(
        pwl,
        store,
        budget_bytes,
        expand_update_spec(spec, pmap),
        cost_model,
        static_fn=partition_static_fn(workload, pwl, pmap, spec),
        solve_fn=solve_fn,
        **run_kw,
    )
    return PartitionedScenarioReport(report=rep, workload=pwl, pmap=pmap)


def verify_partitioned_equivalence(
    workload: Workload,
    part_store: DiskStore,
    n_partitions: int,
    ref_store: DiskStore,
) -> None:
    """Assert every MV assembled from its partitions is bitwise identical to
    the reference (unpartitioned) store's content in canonical order — the
    correctness claim of partition-granular refresh. Raises AssertionError
    with the first divergent column. An MV's partitions and its reference
    are read side by side, one thread each."""
    P = max(int(n_partitions), 1)
    with cf.ThreadPoolExecutor(P + 1) as pool:
        for node in workload.nodes:
            names = ([partition_entry_name(node.name, p) for p in range(P)]
                     if P > 1 else [node.name])
            ref = pool.submit(ref_store.read, node.name)
            parts = list(pool.map(part_store.read, names))
            T.assert_tables_bitwise(
                concat_partitions(parts),
                canonical_order(ref.result()),
                node.name,
            )
