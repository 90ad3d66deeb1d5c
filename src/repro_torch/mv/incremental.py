"""Incremental MV refresh: multi-round full-vs-incremental scenarios
(DESIGN.md §5-6).

The paper's experiment matrix runs every workload under both *full* and
*incremental* updates. This module executes that axis end to end on both
engine backends:

* ``run_scenario``      — real execution. Round 0 is the initial build; each
  later round lands a Z-set delta (inserts, updates as retract+reinsert
  pairs, deletes as tombstones) at every ingesting scan and refreshes the
  DAG under the round's re-solved plan. Under ``mode="incremental"`` the
  delta-propagating operators (tableops module docstring) refresh from
  their weighted input deltas — short-circuited deltas are held in the
  Memory Catalog, delta parts cost delta bytes (tombstones included) on
  storage — while merge/fallback operators rewrite. Under ``mode="full"``
  every non-scan node recomputes from its complete inputs. Both modes
  produce bitwise identical stored MVs (``verify_scenario_equivalence``).
* ``simulate_scenario`` — paper-scale discrete-event counterpart: each
  round's refresh view (``incremental_view``) runs through
  ``engine.simulate_events`` with a freshly solved plan, and the per-round
  sizes the planner sees are fed forward from the previous round's modeled
  full sizes — the simulator's analogue of ``run_scenario`` re-sizing each
  round from the store manifest.

Per-round refresh statuses (``core.speedup``): STATIC nodes (untouched
subtrees) are skipped entirely; APPENDED nodes emit an insert-only delta
(``new = old ++ delta``); DELTA nodes emit a retraction-carrying Z-set
delta spliced by rid (``new = apply_delta(old, Δ±)``); REPLACED nodes
rewrite their output and force their children to full recomputation. A
JOIN whose right-side delta changes the PK first-occurrence mapping — new
keys, deleted keys, updated match payloads — takes the runtime *partial
fallback*: only the affected surviving old-left rows are re-joined and
spliced back by rid (``join_fallbacks`` counts those rounds), instead of
the whole-node recompute of the insert-only model.

The counterpart of ``repro.mv.incremental`` on PyTorch: deltas and tables
are dicts of tensors on the store's device, and every compute path of
``IncrementalEngine`` (scan delta, full refresh, AGG merge, pass-through,
Z-set join) synchronises the device at its end, as the base engine's
``_exec_node`` does, so ``node_seconds`` and the ``compute`` spans time the
work and not the enqueue.

Layer contract: (1) **bitwise equivalence** — a scenario's stored MVs
after any round are identical bytes under incremental and full refresh
(``verify_scenario_equivalence``); optimization decisions (plans, flags,
skips, consolidation) may change *when* and *from where* bytes move,
never their values. (2) **budget feasibility per round** — each round's
plan, whether from the default flat solve or an injected ``solve_fn``
(the partition layer's hierarchical planner), must fit the catalog budget
under every interleaving of the engine's ``n_compute_workers``; the
engine's atomic admission enforces the bound even against stale size
estimates. (3) **durability** — a round ends only when every refreshed MV
is durable on the store (the paper's SLA), so crash-resume never needs
catalog state.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Sequence

import torch

from ..core.altopt import Plan, serial_plan, solve
from ..core.speedup import APPENDED, CHANGED, DELTA, REPLACED, STATIC, CostModel
from ..obs import trace as obs_trace
from ..obs.metrics import METRICS
from . import tableops as T
from .engine import (
    RunReport,
    SimReport,
    ThreadedEngine,
    _RunState,
    _sync_device,
    simulate_events,
)
from .storage import DiskStore
from .workloads import (
    UpdateSpec,
    Workload,
    adaptive_force_full,
    incremental_view,
)


def _retracts(delta: T.Table) -> bool:
    """True when a delta carries a retraction (a negative weight). A
    weightless delta is insert-only and costs no device sync."""
    return T.WEIGHT_COL in delta and bool((delta[T.WEIGHT_COL] < 0).any())


class FallbackRateEwma:
    """EWMA estimator of the observed JOIN partial-fallback rate (the
    fraction of affected right-delta keys that actually matched surviving
    old-left rows). Same estimator shape as the straggler EWMA in
    ``runtime.ft.StragglerDetector.observe`` of the JAX package — first
    observation seeds the average, later ones fold in with weight ``alpha``
    — kept here as its own copy: that module pulls in jax, and the port
    imports nothing of the JAX package. A cumulative ratio would let one
    early high-churn round bias the correction-cost estimate for the rest
    of a long scenario; the EWMA recovers within a few rounds. Rounds with
    no affected keys carry no signal and leave the estimate untouched."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self._avg: float | None = None

    def observe(self, affected: int, matched: int) -> None:
        if affected <= 0:
            return
        r = matched / affected
        self._avg = (
            r if self._avg is None
            else self.alpha * r + (1.0 - self.alpha) * self._avg
        )

    @property
    def rate(self) -> float:
        """Calibrated rate for the next round's planner (1.0 — the
        uncalibrated worst case — until the first observation)."""
        return 1.0 if self._avg is None else self._avg


# ---------------------------------------------------------------------------
# Real (threaded) incremental engine
# ---------------------------------------------------------------------------

class IncrementalEngine(ThreadedEngine):
    """ThreadedEngine with per-round delta refresh semantics.

    One instance drives a whole scenario: the Memory Catalog is engine-owned
    and reused round to round (cleared per run — the restart path), the
    schema cache lets static parents contribute typed empty deltas, and
    ``configure_round`` snapshots the store's part counts so "old content"
    (parts before this round) and "this round's delta" (parts after) stay
    well-defined under write-behind.
    """

    def __init__(self, workload: Workload, store: DiskStore, budget_bytes: float,
                 spec: UpdateSpec, consolidate_ratio: float | None = None, **kw):
        super().__init__(workload, store, budget_bytes, **kw)
        self.spec = spec
        self.consolidate_ratio = consolidate_ratio
        self.round_idx = 0
        self.statuses: dict[int, str] = {}
        self.schemas: dict[str, dict[str, torch.dtype]] = {}
        self._parts0: dict[str, int] = {}
        self._static: frozenset[int] = frozenset()
        self._force_full: frozenset[int] = frozenset()
        self._fb_lock = threading.Lock()
        self.join_fallbacks = 0
        self.fb_affected = 0  # right-delta keys whose PK mapping changed
        self.fb_matched = 0   # ... that actually matched old-left rows

    def configure_round(self, round_idx: int, static: Sequence[int] = (),
                        force_full: Sequence[int] = ()) -> None:
        self.round_idx = round_idx
        self._static = frozenset(static)
        self._force_full = frozenset(force_full)
        self.statuses = {v: STATIC for v in self._static}
        self._parts0 = {
            n.name: self.store.parts(n.name) for n in self.workload.nodes
        }
        self.join_fallbacks = 0
        self.fb_affected = 0
        self.fb_matched = 0

    def _finalize_run(self) -> int:
        """Tombstone consolidation scheduler (ROADMAP debt): after the round
        is durable, rewrite any MV whose tombstone-debt estimate exceeds
        ``consolidate_ratio`` × live bytes as its single live part. Runs
        inside the round's timed window on the throttled store, so the
        consolidation I/O is charged into that round's plan. Round 0 is not
        exempt: a retraction-heavy initial load can already breach the
        ratio, and skipping it would carry that debt into round 1's timed
        window — the ``parts > 1`` guard below is the real precondition
        (consolidation needs old content to fold the tombstones into)."""
        if self.consolidate_ratio is None:
            return 0
        count = 0
        for node in self.workload.nodes:
            if self.store.parts(node.name) > 1 and (
                self.store.tombstone_ratio(node.name) > self.consolidate_ratio
            ):
                self.store.consolidate(node.name)
                count += 1
        return count

    # -- hooks ---------------------------------------------------------------
    def _skip_node(self, v: int, resume: bool) -> bool:
        if v in self._static:
            return True  # untouched subtree: previous output is still exact
        return super()._skip_node(v, resume)

    def _exec_node(self, v: int, rt: _RunState) -> float:
        node = self.workload.nodes[v]
        tn0 = time.perf_counter()
        r = self.round_idx
        if not node.parents:
            # ingestion lands the round's Z-set delta in *every* mode
            # (round 0 = the initial, weightless load)
            if node.delta_fn is None:
                raise ValueError(f"scan {node.name} has no delta_fn")
            with obs_trace.span("compute", node.name):
                delta = node.delta_fn(r, self.spec)
                _sync_device(delta)
            self._publish_delta(v, delta, rt)
            return time.perf_counter() - tn0
        pstat = [self.statuses[p] for p in node.parents]
        if r == 0 or self.spec.mode == "full" or v in self._force_full \
                or REPLACED in pstat:
            self._refresh_full(v, rt)
        else:
            self._refresh_delta(v, rt)
        return time.perf_counter() - tn0

    # -- input access ---------------------------------------------------------
    def _delta_input(self, p: int, rt: _RunState) -> T.Table:
        """This round's Z-set delta of parent ``p`` (APPENDED/DELTA/STATIC)."""
        pname = self.workload.nodes[p].name
        if self.statuses[p] == STATIC:
            return T.empty_like(self.schemas[pname], device=self.store.device)
        if p in rt.flagged and pname in rt.catalog:
            rt.stats.hit(pname)
            with obs_trace.span(
                "read.catalog", pname,
                rt.catalog.entry_bytes(pname) if obs_trace.enabled() else 0.0,
            ):
                return rt.catalog.get(pname)
        rt.stats.miss(pname)
        with obs_trace.span("read.disk", pname):
            return self.store.read_parts(pname, self._parts0[pname])

    def _old_input(self, p: int) -> T.Table:
        """Parent ``p``'s content as of the end of the previous round."""
        return self.store.read_parts(
            self.workload.nodes[p].name, 0, self._parts0[self.workload.nodes[p].name]
        )

    def _old_content(self, p: int) -> T.Table:
        """Previous-round content of ``p`` whatever its status (STATIC means
        the current store content *is* the old content)."""
        if self.statuses[p] == STATIC:
            return self.store.read(self.workload.nodes[p].name)
        return self._old_input(p)

    def _gather_input(self, p: int, rt: _RunState) -> Any:
        """Full current content of parent ``p``, whatever its status."""
        pname = self.workload.nodes[p].name
        status = self.statuses[p]
        if status in CHANGED and p in rt.flagged and pname in rt.catalog:
            # catalog holds only the delta; historical parts come from disk
            rt.stats.hit(pname)
            with obs_trace.span(
                "read.catalog", pname,
                rt.catalog.entry_bytes(pname) if obs_trace.enabled() else 0.0,
            ):
                delta = rt.catalog.get(pname)
            if self._parts0[pname] == 0:
                # first round for this MV: the delta is the whole table
                if T.WEIGHT_COL not in delta:
                    return delta
                return T.materialize_delta(delta)
            rt.stats.miss(pname)
            with obs_trace.span("read.disk", pname):
                old = self._old_input(p)
            return T.apply_delta(old, delta)
        return super()._gather_input(p, rt)

    # -- output publication ----------------------------------------------------
    def _remember_schema(self, name: str, out: T.Table) -> None:
        if out:
            self.schemas[name] = T.table_schema(out)

    def _rows(self, out: T.Table) -> int:
        return len(next(iter(out.values()))) if out else 0

    def _publish_delta(self, v: int, delta: T.Table, rt: _RunState) -> None:
        """Publish a node's round output delta: one appended part on storage
        (tombstones included — retraction bytes are real update I/O), the
        whole delta in the catalog when flagged. Status records what the
        delta was: APPENDED when insert-only, DELTA when it retracts."""
        node = self.workload.nodes[v]
        self._remember_schema(node.name, T.strip_weight(delta))
        if self._rows(delta) == 0 and self.store.exists(node.name):
            self.statuses[v] = STATIC  # empty delta: output is unchanged
            return
        # (an empty *first* delta still writes: a partitioned scan can land
        # zero rows in some partition at round 0, and that partition's MV
        # must exist for later rounds to read its old content / schema)
        retracts = _retracts(delta)
        self.statuses[v] = DELTA if retracts else APPENDED
        # a Z-set delta with |weight| > 1 rows expands to more live bytes
        # than its physical encoding — charge the catalog the larger of the
        # two (the weighted size model for duplicate-row sources); one
        # cached-size pass instead of re-summing the weight column per probe
        size = max(T.table_sizes(delta))
        if v in rt.flagged and rt.catalog.try_put(node.name, delta, size):
            fut = rt.writer.submit(
                self._bg_write, self.store.append, node.name, delta
            )
            with rt.wf_lock:
                rt.write_futures.append(fut)
        else:
            if v in rt.flagged:
                rt.stats.overflowed(node.name)
            with obs_trace.span("write.sync", node.name):
                self.store.append(node.name, delta)

    def _publish_replace(self, v: int, out: T.Table, rt: _RunState) -> None:
        self.statuses[v] = REPLACED
        self._remember_schema(self.workload.nodes[v].name, out)
        self._publish(v, out, rt)  # base behavior: full (replacing) write

    # -- refresh strategies ----------------------------------------------------
    def _refresh_full(self, v: int, rt: _RunState) -> None:
        node = self.workload.nodes[v]
        inputs = [self._gather_input(p, rt) for p in node.parents]
        with obs_trace.span("compute", node.name):
            out = node.fn(inputs)
            _sync_device(out)
        self._publish_replace(v, out, rt)

    def _refresh_delta(self, v: int, rt: _RunState) -> None:
        node = self.workload.nodes[v]
        deltas = [self._delta_input(p, rt) for p in node.parents]
        if all(self._rows(d) == 0 for d in deltas):
            self.statuses[v] = STATIC  # nothing arrived on any input
            return
        retracting = any(_retracts(d) for d in deltas)
        if node.op == "JOIN" and len(node.parents) >= 2:
            self._refresh_join(v, deltas, rt)
        elif node.op == "UNION" and len(node.parents) >= 2 and any(
            "rid" not in self.schemas[self.workload.nodes[p].name]
            for p in node.parents
        ):
            # a rid-less input (an AGG-derived side) leaves the union output
            # without the canonical rid order, so delta rows would land at
            # the wrong row positions — recompute fully instead
            self._refresh_full(v, rt)
        elif node.op == "AGG":
            # mergeable (signed) partial aggregates: agg the weighted delta,
            # merge exactly into the previous output (fixed-point sums —
            # tableops docstring); groups retracted to zero rows drop out
            with obs_trace.span("compute", node.name):
                delta_agg = node.fn([deltas[0]])
            with obs_trace.span("read.disk", node.name):
                old = self.store.read(node.name)
            merged = T.merge_agg(old, delta_agg)
            _sync_device(merged)
            self._publish_replace(v, merged, rt)
        elif retracting and "rid" not in self.schemas[node.name]:
            # retractions splice by rid; a rid-less output (downstream of an
            # AGG) has no row identity to splice against
            self._refresh_full(v, rt)
        else:
            # FILTER / PROJECT / MAP / UNION: pure weighted pass-through;
            # the node's own compute fn applied to the delta IS the delta
            # rule (weights ride along as a meta column)
            deltas = [T.with_weight(d) for d in deltas] if retracting else deltas
            with obs_trace.span("compute", node.name):
                out = node.fn(deltas)
                _sync_device(out)
            self._publish_delta(v, out, rt)

    def _full_from_delta(self, p: int, delta: T.Table) -> T.Table:
        """Parent ``p``'s full current content, assembled from its already-
        gathered delta without re-reading bytes the caller holds."""
        if self.statuses[p] == STATIC:
            return self.store.read(self.workload.nodes[p].name)
        old = self._old_input(p)
        return old if self._rows(delta) == 0 else T.apply_delta(old, delta)

    def _refresh_join(self, v: int, deltas: list[T.Table], rt: _RunState) -> None:
        """Left-driven Z-set delta join, folded across chained right sides:
        left retractions join each old right, left insertions the new right,
        and right-side first-occurrence changes (new keys, deletes, updated
        match payloads) re-join only the affected surviving old-left rows —
        the *partial fallback*, counted in ``join_fallbacks``. Splicing is
        by rid, so the left side must carry one; a rid-less left (downstream
        of an AGG) falls back to a full recompute."""
        node = self.workload.nodes[v]
        left_p = node.parents[0]
        lname = self.workload.nodes[left_p].name
        if "rid" not in self.schemas[lname]:
            self._refresh_full(v, rt)
            return

        def _memo(fn):
            cache: list = []

            def get():
                if not cache:
                    cache.append(fn())
                return cache[0]
            return get

        # old-left content is read (and chained stages' old outputs joined)
        # lazily: the pure delta rule never pays the historical reads — only
        # rounds where the right mapping changed (the partial fallback) do
        get_left = _memo(lambda: self._old_content(left_p))
        dl = T.with_weight(deltas[0])
        corrected = 0
        affected = matched = 0
        rights = list(zip(node.parents[1:], deltas[1:]))
        with obs_trace.span("compute", node.name):
            for j, (p, dp) in enumerate(rights):
                right_old = self._old_content(p)
                fb: dict = {}
                d_next, n_corr = T.zset_join_delta(
                    get_left, dl, right_old, dp, stats=fb
                )
                corrected += n_corr
                affected += fb.get("affected_keys", 0)
                matched += fb.get("matched_keys", 0)
                if j + 1 < len(rights):
                    # the next chained stage's old left is this stage's old
                    # output
                    prev_get, prev_right = get_left, right_old
                    get_left = _memo(
                        lambda g=prev_get, r=prev_right: T.op_join(g(), r)
                    )
                dl = d_next
            _sync_device(dl)
        with self._fb_lock:
            if corrected:
                self.join_fallbacks += 1
            self.fb_affected += affected
            self.fb_matched += matched
        self._publish_delta(v, dl, rt)


# ---------------------------------------------------------------------------
# Scenario drivers
# ---------------------------------------------------------------------------

def round_view(
    workload: Workload,
    spec: UpdateSpec,
    cost_model: CostModel,
    round_idx: int,
    store: DiskStore | None = None,
    fallback_rate: float = 1.0,
) -> tuple[Workload, list[float], frozenset]:
    """One round's planner inputs: ``(view, sizes, force_full)``.

    Round 0 plans the initial build against the workload's modeled sizes;
    later rounds size every node from the store manifest (the paper's
    "metrics from previous runs") and plan against the refresh view
    evaluated one round ahead of *current* sizes (``round_idx=1`` inside
    ``incremental_view``) rather than compounding growth from round 0. The
    JOIN correction term uses the caller's calibrated ``fallback_rate``
    (``FallbackRateEwma``), and ``spec.mode="adaptive"`` additionally
    returns the per-view full-recompute choices (``adaptive_force_full``)
    the view was evaluated under. Shared by ``run_scenario`` and the
    multi-host coordinator (``mv.multihost``) so both drivers plan every
    round from identical inputs."""
    if round_idx == 0:
        return workload, [float(n.size) for n in workload.nodes], frozenset()
    manifest = store.manifest() if store is not None else {}
    sizes = [
        float(manifest.get(n.name, n.size)) or 1.0 for n in workload.nodes
    ]
    force_full: frozenset = frozenset()
    if spec.mode == "adaptive":
        # Enzyme-style per-view choice: nodes whose modeled delta refresh
        # costs more than recomputing them outright (under the calibrated
        # fallback rate) run full this round — the planner prices the same
        # decision via the view below.
        force_full = adaptive_force_full(
            workload, spec, cost_model, 1, sizes=sizes,
            fallback_rate=fallback_rate,
        )
    view = incremental_view(
        workload, spec, 1, sizes=sizes, fallback_rate=fallback_rate,
        force_full=force_full,
    )
    return view, sizes, force_full


@dataclasses.dataclass
class RoundReport:
    round_idx: int
    mode: str
    plan: Plan
    run: RunReport
    statuses: dict[str, str]
    join_fallbacks: int
    # per-node full sizes the round's planner saw (round 0: workload sizes;
    # later rounds: store-manifest observations) — the real-side quantity the
    # simulator's fed-forward sizes are compared against for parity
    sizes: tuple[float, ...] = ()
    # observed JOIN partial-fallback profile of this round: ``affected``
    # right-delta keys whose PK mapping changed, ``matched`` of those that
    # actually hit old-left rows (both per-round counts), ``rate_used`` the
    # rate this round's planner fed into the correction-cost term, and
    # ``rate_ewma`` the estimator state after folding this round in
    # (``FallbackRateEwma`` — what the *next* round will use)
    fallback_stats: dict | None = None
    # names the adaptive chooser forced to full recompute this round
    # (mode="adaptive" only; empty otherwise)
    forced_full: tuple[str, ...] = ()
    # per-node speedup scores of the round's solved graph (index-aligned
    # with workload.nodes): the planner's predicted per-node benefit that
    # ``obs.audit`` joins against realized savings from the trace
    scores: tuple[float, ...] = ()
    # host seconds this round spent planning: sizing the round's view from
    # the store manifest, scoring it and solving the plan
    plan_seconds: float = 0.0

    @property
    def elapsed(self) -> float:
        return self.run.elapsed

    @property
    def consolidations(self) -> int:
        return self.run.consolidations

    @property
    def entry_stats(self) -> dict[str, dict[str, int]]:
        """Per-entry catalog hit/miss/overflow tallies of this round's run."""
        return self.run.entry_stats


@dataclasses.dataclass
class ScenarioReport:
    workload: str
    spec: UpdateSpec
    rounds: list[RoundReport]

    @property
    def build_seconds(self) -> float:
        return self.rounds[0].elapsed if self.rounds else 0.0

    @property
    def refresh_seconds(self) -> float:
        return sum(r.elapsed for r in self.rounds[1:])

    @property
    def peak_catalog_bytes(self) -> float:
        return max((r.run.peak_catalog_bytes for r in self.rounds), default=0.0)


def run_scenario(
    workload: Workload,
    store: DiskStore,
    budget_bytes: float,
    spec: UpdateSpec,
    cost_model: CostModel,
    n_compute_workers: int = 1,
    n_writers: int = 1,
    optimize: bool = True,
    static_fn=None,
    consolidate_ratio: float | None = None,
    solve_fn=None,
) -> ScenarioReport:
    """Execute a multi-round refresh scenario on real data.

    Round 0 builds every MV; rounds ``1..spec.n_rounds`` ingest and refresh
    under ``spec.mode``. The planner re-solves each round against the
    round's refresh view, sized from the store manifest (the paper's
    "metrics from previous runs"); ``optimize=False`` runs every round
    serially with nothing flagged (the no-opt baseline).

    ``static_fn(round_idx, view_static) -> extra static node ids`` adds
    data-dependent skips on top of the analytic view's STATIC statuses —
    the partition layer prunes clean partitions with it. The JOIN
    correction-cost term is calibrated per round from an EWMA of the
    engine's observed partial-fallback rates (``FallbackRateEwma``,
    ``RoundReport.fallback_stats``), ``spec.mode="adaptive"`` additionally
    lets that calibrated model force individual views to full recompute on
    rounds where the delta path is the loser (``RoundReport.forced_full``,
    DESIGN.md §11), and ``consolidate_ratio`` arms the tombstone
    consolidation scheduler (``IncrementalEngine._finalize_run``).

    ``solve_fn(graph, budget, n_workers) -> Plan`` overrides the per-round
    planner (it must return a plan feasible at ``n_workers``); the
    partition layer passes the hierarchical partitioned solver here so
    high-P scenarios keep per-round planning off the critical path
    (DESIGN.md §8). Default: the flat ``altopt.solve``."""
    stale = {n.name for n in workload.nodes} & set(store.manifest())
    if stale:
        raise ValueError(
            f"store already holds {len(stale)} of this workload's MVs "
            f"(e.g. {sorted(stale)[:3]}); scenarios must start on an empty "
            "store or round-0 ingestion would append onto stale parts"
        )
    engine = IncrementalEngine(
        workload, store, budget_bytes, spec,
        n_compute_workers=n_compute_workers, n_writers=n_writers,
        consolidate_ratio=consolidate_ratio,
    )
    rounds: list[RoundReport] = []
    fb_ewma = FallbackRateEwma()  # observed fallback-rate estimator
    for r in range(spec.n_rounds + 1):
        rate_used = fb_ewma.rate
        t_plan = time.perf_counter()
        # manifest sizes already include all growth up to round r-1; the
        # JOIN correction term uses the EWMA of the per-round fallback
        # rates observed so far (1.0 until the first observation) — a
        # single churn spike decays instead of biasing every later round
        # the way a cumulative ratio would (round_view).
        view, sizes, force_full = round_view(
            workload, spec, cost_model, r, store=store,
            fallback_rate=rate_used,
        )
        g = view.to_graph(cost_model)
        if not optimize:
            plan = serial_plan(g)
        elif solve_fn is not None:
            plan = solve_fn(g, budget_bytes, n_compute_workers)
        else:
            plan = solve(g, budget=budget_bytes, n_workers=n_compute_workers)
        plan_seconds = time.perf_counter() - t_plan
        statuses = view.meta.get("update", {}).get("statuses", ())
        static = frozenset(i for i, s in enumerate(statuses) if s == STATIC)
        if static_fn is not None:
            static = static | frozenset(static_fn(r, static))
        engine.configure_round(r, sorted(static), sorted(force_full))
        rep = engine.run(plan)
        fb_ewma.observe(engine.fb_affected, engine.fb_matched)
        rounds.append(
            RoundReport(
                round_idx=r,
                mode=spec.mode if r else "build",
                plan=plan,
                run=rep,
                statuses={
                    workload.nodes[v].name: s
                    for v, s in engine.statuses.items()
                },
                join_fallbacks=engine.join_fallbacks,
                sizes=tuple(sizes),
                fallback_stats=dict(
                    affected=engine.fb_affected,
                    matched=engine.fb_matched,
                    rate_used=rate_used,
                    rate_ewma=fb_ewma.rate,
                ),
                forced_full=tuple(
                    workload.nodes[v].name for v in sorted(force_full)
                ),
                scores=tuple(g.scores),
                plan_seconds=plan_seconds,
            )
        )
        if obs_trace.enabled() and engine.join_fallbacks:
            METRICS.inc("join_fallbacks", engine.join_fallbacks)
    return ScenarioReport(workload=workload.name, spec=spec, rounds=rounds)


def verify_scenario_equivalence(
    workload: Workload, store_a: DiskStore, store_b: DiskStore
) -> None:
    """Assert every MV is bitwise identical between two scenario stores
    (incremental vs full recompute — the correctness claim of DESIGN.md §5).
    Raises AssertionError with the first divergent column."""
    for node in workload.nodes:
        T.assert_tables_bitwise(
            store_a.read(node.name), store_b.read(node.name), node.name
        )


# ---------------------------------------------------------------------------
# Discrete-event scenarios (paper scale)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimRoundReport:
    round_idx: int
    mode: str
    plan: Plan
    sim: SimReport
    # per-node full sizes this round's planner saw (fed forward from the
    # previous round's modeled full sizes — the simulated store manifest)
    sizes: tuple[float, ...] = ()

    @property
    def end_to_end(self) -> float:
        return self.sim.end_to_end


@dataclasses.dataclass
class SimScenarioReport:
    workload: str
    spec: UpdateSpec
    method: str
    rounds: list[SimRoundReport]

    @property
    def build_seconds(self) -> float:
        return self.rounds[0].end_to_end if self.rounds else 0.0

    @property
    def refresh_seconds(self) -> float:
        return sum(r.end_to_end for r in self.rounds[1:])

    @property
    def total_seconds(self) -> float:
        return sum(r.end_to_end for r in self.rounds)


def simulate_scenario(
    workload: Workload,
    spec: UpdateSpec,
    cost_model: CostModel,
    budget_bytes: float,
    method: str = "sc",
    n_workers: int = 1,
    n_writers: int | None = None,
    solve_fn=None,
) -> SimScenarioReport:
    """Discrete-event multi-round refresh (paper-scale full-vs-incremental).

    Each round's refresh view feeds the shared event engine; ``method="sc"``
    re-solves the plan per round against the view's update-mode speedup
    scores, ``method="serial"`` is the no-opt baseline. Sizes are fed
    forward round to round — each refresh view is evaluated one round ahead
    of the previous round's modeled full sizes, exactly how the real
    ``run_scenario`` re-sizes each round from the store manifest — instead
    of compounding the analytic growth model from round 0.

    ``solve_fn(graph, budget, n_workers) -> Plan`` overrides the per-round
    ``method="sc"`` planner, as in ``run_scenario`` — the hook the partition
    layer uses for hierarchical planning at high P (DESIGN.md §8)."""
    rounds: list[SimRoundReport] = []
    sizes = [float(n.size) for n in workload.nodes]
    for r in range(spec.n_rounds + 1):
        if r == 0:
            view = workload
        else:
            view = incremental_view(workload, spec, 1, sizes=sizes)
        g = view.to_graph(cost_model)
        if method == "serial":
            plan, mode = serial_plan(g), "serial"
        elif method == "sc":
            plan = (
                solve_fn(g, budget_bytes, n_workers)
                if solve_fn is not None
                else solve(g, budget=budget_bytes, n_workers=n_workers)
            )
            mode = "sc"
        else:
            raise ValueError(f"unknown method {method!r}")
        obs_trace.set_round(r)
        sim = simulate_events(
            view, plan, cost_model, mode=mode, n_workers=n_workers,
            n_writers=n_writers,
        )
        rounds.append(
            SimRoundReport(
                round_idx=r, mode=spec.mode if r else "build", plan=plan,
                sim=sim, sizes=tuple(sizes),
            )
        )
        if r > 0:
            # observed-size feedback: next round plans against this round's
            # modeled full sizes (the simulated manifest)
            sizes = [float(s) for s in view.meta["update"]["full_sizes"]]
    return SimScenarioReport(
        workload=workload.name, spec=spec, method=method, rounds=rounds
    )
