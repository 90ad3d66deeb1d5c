"""Unified event-driven execution engine for MV refresh runs.

Both execution paths of the system — the real ``Controller`` (executor.py)
and the discrete-event simulation (``simulate_events``) — are thin backends
over the one scheduling core defined here:

* ``ScheduleCore``    — DAG readiness, the dispatch discipline, and Memory
                        Catalog admission/residency/release bookkeeping.
* ``ThreadedEngine``  — real execution: k compute worker threads pull ready
                        nodes, flagged outputs are admitted to a shared
                        thread-safe ``MemoryCatalog`` and materialized by a
                        background writer pool (Fig. 6 write-behind).
* ``simulate_events`` — discrete-event execution: k virtual compute channels
                        plus background writer channels advance an event
                        clock using ``CostModel`` costs instead of wall time.

Dispatch discipline (what makes k-worker feasibility checkable):
nodes are *issued* strictly in plan order; node ``order[i]`` may start only
once (a) all of its parents have completed, (b) ``order[i-k]`` has completed
(the window constraint), and (c) a compute channel is free. Completion is
out of order. Under this discipline a flagged node's catalog residency is
contained in plan-order steps ``[pos(v), lc(v) + k - 1]`` — exactly the
window ``MVGraph.resident_sets(..., n_workers=k)`` charges — so plans from
``altopt.solve(..., n_workers=k)`` never exceed the byte budget under *any*
interleaving the engine can produce. With ``k = 1`` the discipline reduces
to the paper's serial statement stream. See DESIGN.md §1-2.

Partitioned workloads (``mv.partition``) need nothing special here: the
P-way expansion makes each (mv, partition) its own node with co-partitioned
edges only, so partitions of one MV are mutually independent in the DAG and
the same dispatch discipline runs a single wide MV data-parallel across the
k workers (DESIGN.md §7).

On the card, a node's compute is a stream of asynchronous kernel launches:
``_exec_node`` synchronises the device when the node's output lies on it,
so ``node_seconds`` and the ``compute`` spans time the work, not the
enqueue. Compute and writer threads share PyTorch's default stream, which
keeps a writer's device-to-host copy ordered after the compute.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Iterable, Sequence

import torch

from ..core.altopt import Plan
from ..core.speedup import CostModel
from ..obs import trace as obs_trace
from ..obs.metrics import METRICS
from .catalog import MemoryCatalog
from .storage import DiskStore
from .tableops import table_sizes
from .workloads import Workload


class InjectedCrash(RuntimeError):
    """Raised by tests to simulate a mid-run failure."""


def _sync_device(table: dict) -> None:
    """Wait for the kernels that produced ``table`` when it lies on a CUDA
    device (a no-op for CPU tables)."""
    for v in table.values():
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
        return


def _check_plan_concurrency(plan: Plan, k: int) -> None:
    """Warn when a plan is executed at higher concurrency than it was solved
    for: the k-worker residency windows are wider than the ones the solver
    verified, so the byte-budget guarantee no longer covers this run."""
    solved_for = getattr(plan, "n_workers", 1)
    if plan.flagged and solved_for < k:
        warnings.warn(
            f"plan was solved for n_workers={solved_for} but is executing on "
            f"{k} channels; peak catalog usage may exceed the solver's budget "
            "(re-solve with altopt.solve(..., n_workers=k))",
            RuntimeWarning,
            stacklevel=3,
        )


# ---------------------------------------------------------------------------
# Shared scheduling core
# ---------------------------------------------------------------------------

class ScheduleCore:
    """Backend-agnostic scheduling state for one MV refresh run.

    Owns the children/pending bookkeeping both backends used to duplicate:
    which node may be issued next (in-order issue + window-k + parents
    complete), and which flagged catalog entries become releasable when a
    node completes (its parents' last child just finished, or the node
    itself is childless).
    """

    def __init__(
        self,
        workload: Workload,
        order: Sequence[int],
        flagged: Iterable[int],
        n_workers: int = 1,
    ):
        n = workload.n
        self.order = list(order)
        if sorted(self.order) != list(range(n)):
            raise ValueError("plan order must be a permutation of workload nodes")
        self.workload = workload
        self.flagged = frozenset(flagged)
        self.n_workers = max(int(n_workers), 1)
        self.children: list[list[int]] = [[] for _ in range(n)]
        for i, node in enumerate(workload.nodes):
            for p in node.parents:
                self.children[p].append(i)
        self.pending_children = [len(c) for c in self.children]
        self.completed = [False] * n
        self.issued = [False] * n
        self.next_issue = 0
        self.n_done = 0

    @property
    def n(self) -> int:
        return len(self.order)

    def done(self) -> bool:
        return self.n_done == self.n

    def next_ready(self) -> int | None:
        """Node to issue next, or None (order exhausted / head not ready)."""
        i = self.next_issue
        if i >= self.n:
            return None
        w = i - self.n_workers
        if w >= 0 and not self.completed[self.order[w]]:
            return None  # window: order[i-k] must have completed
        v = self.order[i]
        if any(not self.completed[p] for p in self.workload.nodes[v].parents):
            return None  # in-order issue: wait for the head's parents
        return v

    def issue(self) -> int:
        v = self.next_ready()
        if v is None:
            raise RuntimeError("issue() called with no dispatchable node")
        self.issued[v] = True
        self.next_issue += 1
        return v

    def complete(self, v: int) -> list[int]:
        """Mark v complete; return node ids whose catalog entry is now
        releasable (flagged parents whose last child just completed, plus v
        itself when flagged and childless)."""
        if not self.issued[v] or self.completed[v]:
            raise RuntimeError(f"complete({v}) out of protocol")
        self.completed[v] = True
        self.n_done += 1
        released: list[int] = []
        for p in self.workload.nodes[v].parents:
            self.pending_children[p] -= 1
            if self.pending_children[p] == 0 and p in self.flagged:
                released.append(p)
        if v in self.flagged and not self.children[v]:
            released.append(v)  # childless: free immediately
        return released


class SubSchedule:
    """One host's slice of a multi-host round: the in-order-issue + window-k
    dispatch discipline over a sub-order of the expanded graph, with
    completion reported externally.

    ``ScheduleCore`` owns a whole workload's DAG bookkeeping in one process;
    the multi-host coordinator (``mv.multihost``) runs one discipline *per
    host* over disjoint sub-orders, where completions can arrive from other
    hosts (fault re-dispatch) and parent readiness depends on cross-host
    durability the coordinator alone knows. This core keeps only the
    discipline that makes per-host plans feasibility-checkable — ``order[i]``
    may be issued only once ``order[i-k]`` has completed — and takes parent
    readiness as a predicate. Completed nodes at the head (statics, nodes
    that became durable elsewhere) are skipped, fault re-dispatch appends
    recovered nodes with ``extend``, and ``reopen`` rolls back a completion
    that died with the host holding it."""

    def __init__(self, order: Sequence[int], n_workers: int = 1):
        self.order = list(order)
        self.window = max(int(n_workers), 1)
        self.next_issue = 0
        self._done: set[int] = set()

    def complete(self, v: int) -> None:
        self._done.add(v)

    def reopen(self, v: int) -> None:
        self._done.discard(v)

    def extend(self, nodes: Iterable[int]) -> None:
        self.order.extend(nodes)

    def unissued(self) -> list[int]:
        """Nodes not yet issued nor completed, in order."""
        return [v for v in self.order[self.next_issue:] if v not in self._done]

    def next_ready(self, parent_ok) -> int | None:
        """Next issuable node, or None (exhausted / window blocked / head's
        parents not ready per ``parent_ok``). Does not advance — call
        ``issue`` to commit."""
        while (
            self.next_issue < len(self.order)
            and self.order[self.next_issue] in self._done
        ):
            self.next_issue += 1
        i = self.next_issue
        if i >= len(self.order):
            return None
        w = i - self.window
        if w >= 0 and self.order[w] not in self._done:
            return None
        v = self.order[i]
        if not parent_ok(v):
            return None
        return v

    def issue(self) -> int:
        v = self.order[self.next_issue]
        self.next_issue += 1
        return v


# ---------------------------------------------------------------------------
# Real (threaded) backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunReport:
    elapsed: float
    peak_catalog_bytes: float
    catalog_hits: int
    disk_reads: int
    overflow_fallbacks: int
    executed: list[str]
    skipped: list[str]
    read_seconds: float
    write_seconds: float
    node_seconds: dict[str, float]
    n_workers: int = 1
    consolidations: int = 0  # tombstone consolidations charged to this run
    # real wall-clock (node, start, end) per executed node, seconds relative
    # to run start, sorted by start — same shape as ``SimReport.timeline``
    # so real and simulated runs overlay directly (obs.export)
    timeline: list[tuple[str, float, float]] = dataclasses.field(
        default_factory=list
    )
    # per-entry catalog outcome tallies: name -> {hits, misses, overflow}
    entry_stats: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict
    )


class _Counters:
    """Thread-safe hit/miss/overflow tallies shared by compute workers,
    kept both in aggregate and per store-entry name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.overflow = 0
        self._by_entry: dict[str, list[int]] = {}

    def _entry(self, name: str) -> list[int]:
        e = self._by_entry.get(name)
        if e is None:
            e = self._by_entry[name] = [0, 0, 0]
        return e

    def hit(self, name: str = ""):
        with self._lock:
            self.hits += 1
            self._entry(name)[0] += 1

    def miss(self, name: str = ""):
        with self._lock:
            self.misses += 1
            self._entry(name)[1] += 1

    def overflowed(self, name: str = ""):
        with self._lock:
            self.overflow += 1
            self._entry(name)[2] += 1

    def entry_stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                k: {"hits": h, "misses": m, "overflow": o}
                for k, (h, m, o) in sorted(self._by_entry.items())
            }


@dataclasses.dataclass
class _RunState:
    """Per-run shared state handed to worker threads."""

    catalog: MemoryCatalog
    stats: _Counters
    writer: ThreadPoolExecutor
    write_futures: list[Future]
    wf_lock: threading.Lock
    flagged: frozenset[int]
    t0: float = 0.0  # run start (perf_counter) for timeline timestamps
    timeline: list = dataclasses.field(default_factory=list)


class ThreadedEngine:
    """Real execution on the shared core: k compute workers + write-behind.

    The coordinator (caller's thread) owns the ``ScheduleCore`` — issuing
    nodes, processing completions, and releasing catalog entries. Workers
    gather inputs (catalog hit or storage read), run the node's compute
    function, and admit/persist the output. A flagged output is created in
    the catalog and its materialization enqueued on the background writer
    pool (persistence overlaps downstream compute); an unflagged output — or
    a flagged one whose true size no longer fits — is written synchronously
    on the worker's own channel. The run only concludes when every MV is
    durable on storage (the paper's SLA), crash or no crash.

    Node execution is factored into overridable hooks (``_skip_node``,
    ``_exec_node``, ``_gather_input``, ``_publish``) so refresh disciplines
    other than build-from-scratch — notably the incremental engine
    (``mv.incremental``) — reuse the scheduling/admission/SLA machinery
    unchanged. The Memory Catalog object is owned by the engine and shared
    across ``run`` calls (multi-round refresh, crash/resume restarts);
    contents are per-run — each run starts by clearing it, which also
    resets the peak statistic.
    """

    def __init__(
        self,
        workload: Workload,
        store: DiskStore,
        budget_bytes: float,
        n_compute_workers: int = 1,
        n_writers: int = 1,
    ):
        self.workload = workload
        self.store = store
        self.budget = float(budget_bytes)
        self.n_compute_workers = max(int(n_compute_workers), 1)
        self.n_writers = max(int(n_writers), 1)
        self.catalog = MemoryCatalog(self.budget)

    # -- overridable execution hooks ----------------------------------------
    def _skip_node(self, v: int, resume: bool) -> bool:
        """True when node v need not execute this run (already durable)."""
        return resume and self.store.exists(self.workload.nodes[v].name)

    def _gather_input(self, p: int, rt: _RunState) -> Any:
        pname = self.workload.nodes[p].name
        # A flagged parent stays resident until its last child has
        # *completed*, so this read can never race its release.
        if p in rt.flagged and pname in rt.catalog:
            rt.stats.hit(pname)
            with obs_trace.span(
                "read.catalog", pname,
                rt.catalog.entry_bytes(pname) if obs_trace.enabled() else 0.0,
            ):
                return rt.catalog.get(pname)
        rt.stats.miss(pname)
        with obs_trace.span("read.disk", pname):
            return self.store.read(pname)

    def _bg_write(self, write_fn, name: str, table) -> float:
        """Background materialization, spanned on the writer's own thread
        (the Fig. 6 write-behind drain)."""
        with obs_trace.span("write.behind", name):
            return write_fn(name, table)

    def _publish(self, v: int, out: Any, rt: _RunState) -> None:
        node = self.workload.nodes[v]
        # cached-size path: weight-column sums are memoized per array, so a
        # weighted part admitted repeatedly is not re-summed (tableops)
        size = max(table_sizes(out))
        if v in rt.flagged and rt.catalog.try_put(node.name, out, size):
            fut = rt.writer.submit(self._bg_write, self.store.write,
                                   node.name, out)
            with rt.wf_lock:
                rt.write_futures.append(fut)
        else:
            if v in rt.flagged:
                rt.stats.overflowed(node.name)  # estimate too small; degrade
            with obs_trace.span("write.sync", node.name):
                self.store.write(node.name, out)

    def _exec_node(self, v: int, rt: _RunState) -> float:
        node = self.workload.nodes[v]
        tn0 = time.perf_counter()
        inputs = [self._gather_input(p, rt) for p in node.parents]
        if node.fn is None:
            raise ValueError(f"node {node.name} has no compute fn")
        with obs_trace.span("compute", node.name):
            out = node.fn(inputs)
            _sync_device(out)
        self._publish(v, out, rt)
        return time.perf_counter() - tn0

    def _timed_exec(self, v: int, rt: _RunState) -> float:
        """Worker entry point: one node end to end, recorded as a ``task``
        span and a ``RunReport.timeline`` row (list.append is atomic)."""
        name = self.workload.nodes[v].name
        start = time.perf_counter()
        with obs_trace.span("task", name):
            dt = self._exec_node(v, rt)
        rt.timeline.append((name, start - rt.t0, time.perf_counter() - rt.t0))
        return dt

    def _finalize_run(self) -> int:
        """Post-drain maintenance charged into the run's elapsed time (the
        incremental engine's tombstone consolidation pass); returns the
        number of consolidations performed."""
        return 0

    # -- coordinator ---------------------------------------------------------
    def run(
        self,
        plan: Plan,
        resume: bool = False,
        crash_after: int | None = None,
    ) -> RunReport:
        wl = self.workload
        flagged = frozenset(plan.flagged)
        _check_plan_concurrency(plan, self.n_compute_workers)
        core = ScheduleCore(wl, plan.order, flagged, self.n_compute_workers)
        # restart path: the engine-owned catalog is reused across rounds and
        # resume attempts — clear() drops stale entries and resets the peak
        # statistic (reset_stats() alone keeps residents)
        self.catalog.clear()
        stats = _Counters()
        executed: list[str] = []
        skipped: list[str] = []
        node_seconds: dict[str, float] = {}
        self.store.reset_counters()

        def process_completion(v: int) -> None:
            for r in core.complete(v):
                self.catalog.release(wl.nodes[r].name)

        round_idx = int(getattr(self, "round_idx", 0))
        obs_trace.set_round(round_idx)
        tr0 = obs_trace.now()
        t0 = time.perf_counter()
        pool = ThreadPoolExecutor(max_workers=self.n_compute_workers)
        writer = ThreadPoolExecutor(max_workers=self.n_writers)
        rt = _RunState(
            catalog=self.catalog,
            stats=stats,
            writer=writer,
            write_futures=[],
            wf_lock=threading.Lock(),
            flagged=flagged,
            t0=t0,
        )
        inflight: dict[Future, int] = {}
        try:
            while not core.done():
                while len(inflight) < self.n_compute_workers:
                    v = core.next_ready()
                    if v is None:
                        break
                    core.issue()
                    node = wl.nodes[v]
                    if self._skip_node(v, resume):
                        # already durable (resume) or untouched this round
                        # (static): complete it instantly so bookkeeping
                        # (and releases) advance
                        skipped.append(node.name)
                        process_completion(v)
                        continue
                    inflight[pool.submit(self._timed_exec, v, rt)] = v
                if core.done():
                    break
                if not inflight:
                    raise RuntimeError(
                        "scheduler deadlock: head blocked with nothing in flight"
                    )
                done_set, _ = wait(inflight, return_when=FIRST_COMPLETED)
                for f in done_set:
                    v = inflight.pop(f)
                    dt = f.result()
                    executed.append(wl.nodes[v].name)
                    node_seconds[wl.nodes[v].name] = dt
                    process_completion(v)
                    if crash_after is not None and len(executed) >= crash_after:
                        raise InjectedCrash(
                            f"crash injected after {crash_after} nodes"
                        )
        finally:
            # SLA: never conclude (or crash out) with writes in unknown state.
            # Let in-flight compute finish, then drain the background writer.
            pool.shutdown(wait=True)
            for f in list(rt.write_futures):
                f.result()
            writer.shutdown(wait=True)
        # post-drain maintenance (tombstone consolidation) is charged into
        # this run's elapsed time — the round's plan pays its own debt
        consolidations = self._finalize_run()
        elapsed = time.perf_counter() - t0
        if obs_trace.enabled():
            # the round frame every other span of this run nests inside
            obs_trace.record(
                "round", f"round{round_idx}", tr0, obs_trace.now() - tr0
            )
            METRICS.observe("round_wall_s", elapsed)
            for name, es in stats.entry_stats().items():
                METRICS.inc("catalog_hits", es["hits"], entry=name)
                METRICS.inc("catalog_misses", es["misses"], entry=name)
                METRICS.inc("catalog_overflow", es["overflow"], entry=name)
        return RunReport(
            elapsed=elapsed,
            peak_catalog_bytes=self.catalog.peak_bytes,
            catalog_hits=stats.hits,
            disk_reads=stats.misses,
            overflow_fallbacks=stats.overflow,
            executed=executed,
            skipped=skipped,
            read_seconds=self.store.read_seconds,
            write_seconds=self.store.write_seconds,
            node_seconds=node_seconds,
            n_workers=self.n_compute_workers,
            consolidations=consolidations,
            timeline=sorted(rt.timeline, key=lambda x: (x[1], x[0])),
            entry_stats=stats.entry_stats(),
        )


# ---------------------------------------------------------------------------
# Discrete-event backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimReport:
    end_to_end: float
    compute_seconds: float
    blocking_read_seconds: float
    blocking_write_seconds: float
    background_write_seconds: float
    peak_catalog_bytes: float
    catalog_hits: int
    timeline: list[tuple[str, float, float]]  # (node, start, end) per channel
    critical_path_seconds: float = 0.0
    n_workers: int = 1

    @property
    def table_read_seconds(self) -> float:
        return self.blocking_read_seconds


def simulate_events(
    workload: Workload,
    plan: Plan,
    cost_model: CostModel,
    mode: str = "sc",
    n_workers: int = 1,
    lru_budget: float | None = None,
    n_writers: int | None = None,
) -> SimReport:
    """Discrete-event run over k genuine compute channels.

    Costs come from ``cost_model``; scheduling follows the same
    ``ScheduleCore`` discipline as the real engine, so ``n_workers=1``
    reproduces the paper's serial statement stream exactly and ``k > 1``
    models a k-node cluster (Table V) with per-node blocking I/O and
    ``n_writers`` background materialization channels (default: one per
    compute channel — the paper's NFS is not saturated at 5 workers).
    """
    wl = workload
    cm = cost_model
    k = max(int(n_workers), 1)
    nw = k if n_writers is None else max(int(n_writers), 1)
    flagged = frozenset(plan.flagged) if mode == "sc" else frozenset()
    if mode == "sc":
        _check_plan_concurrency(plan, k)
    core = ScheduleCore(wl, plan.order, flagged, k)

    worker_free = [0.0] * k
    writer_free = [0.0] * nw
    prev_issue = 0.0  # in-order issue: start times are nondecreasing
    complete_t = [0.0] * wl.n
    cp = [0.0] * wl.n  # critical-path completion lower bound
    compute_total = 0.0
    blocking_read = 0.0
    blocking_write = 0.0
    background_write = 0.0
    hits = 0
    timeline: list[tuple[str, float, float]] = []
    # catalog residency as timed events: (time, kind, delta) with admissions
    # (kind 0) before releases (kind 1) at equal timestamps, matching the
    # serial accounting where a node is admitted before its parents release
    events: list[tuple[float, int, float]] = []

    lru: OrderedDict[int, float] = OrderedDict()
    lru_bytes = 0.0
    lru_cap = (lru_budget if lru_budget is not None else 0.0) if mode == "lru" else 0.0

    # span emission under the real engine's schema, on the simulated clock
    # (ts offset by the scenario driver's cumulative round time so multi-
    # round simulated traces lay out sequentially like real ones)
    tr = obs_trace.enabled()
    off = obs_trace.sim_offset() if tr else 0.0

    def emit(cat: str, name: str, ts: float, dur: float, worker: str,
             nbytes: float = 0.0) -> None:
        obs_trace.record(cat, name, off + ts, dur, nbytes=nbytes,
                         worker=worker, track="sim")

    for i, v in enumerate(core.order):
        node = wl.nodes[v]
        core.issue()
        ch = min(range(k), key=lambda c: worker_free[c])
        chname = f"ch{ch}"
        t = max(worker_free[ch], prev_issue)
        for p in node.parents:
            t = max(t, complete_t[p])
        if i >= k:
            t = max(t, complete_t[core.order[i - k]])  # window constraint
        start = t
        prev_issue = t
        # -- input access (blocks this channel only) -------------------------
        if node.base_read:
            dt = cm.read_base(node.base_read)  # base tables: never cached
            if tr:
                emit("read.base", node.name, t, dt, chname, node.base_read)
            t += dt
            blocking_read += dt
        for p in node.parents:
            psize = wl.nodes[p].size
            pname = wl.nodes[p].name
            if p in flagged:
                dt = cm.read_mem(psize)
                if tr:
                    emit("read.catalog", pname, t, dt, chname, psize)
                t += dt
                hits += 1
            elif mode == "lru" and p in lru:
                dt = cm.read_mem(psize)
                if tr:
                    emit("read.catalog", pname, t, dt, chname, psize)
                t += dt
                lru.move_to_end(p)
                hits += 1
            else:
                dt = cm.read_disk(psize)
                if tr:
                    emit("read.disk", pname, t, dt, chname, psize)
                t += dt
                blocking_read += dt
        # -- compute (one full statement on one channel) ----------------------
        if tr:
            emit("compute", node.name, t, node.compute, chname)
        t += node.compute
        compute_total += node.compute
        # -- output creation ---------------------------------------------------
        if v in flagged:
            t += cm.write_mem(node.size)
            events.append((t, 0, node.size))
            wc = min(range(nw), key=lambda c: writer_free[c])
            wdur = cm.write_disk(node.size)
            wstart = max(t, writer_free[wc])
            writer_free[wc] = wstart + wdur
            background_write += wdur
            if tr:
                emit("admit", node.name, t, 0.0, chname, node.size)
                emit("write.behind", node.name, wstart, wdur, f"w{wc}",
                     node.size)
        else:
            dt = cm.write_disk(node.size)
            if tr:
                emit("write.sync", node.name, t, dt, chname, node.size)
            t += dt
            blocking_write += dt
            if mode == "lru" and node.size <= lru_cap:
                lru[v] = node.size
                lru_bytes += node.size
                while lru_bytes > lru_cap:
                    _, evicted = lru.popitem(last=False)
                    lru_bytes -= evicted
        complete_t[v] = t
        worker_free[ch] = t
        timeline.append((node.name, start, t))
        if tr:
            emit("task", node.name, start, t - start, chname)
        cp[v] = (t - start) + max((cp[p] for p in node.parents), default=0.0)
        # -- releases: a flagged node frees when its last child completes ------
        for r in core.complete(v):
            rel_t = max(
                (complete_t[c] for c in core.children[r]), default=complete_t[r]
            )
            events.append((rel_t, 1, -wl.nodes[r].size))
            if tr:
                emit("release", wl.nodes[r].name, rel_t, 0.0, "cat",
                     wl.nodes[r].size)

    cat_used = cat_peak = 0.0
    for ev_t, _, delta in sorted(events, key=lambda e: (e[0], e[1])):
        cat_used += delta
        cat_peak = max(cat_peak, cat_used)
        if tr:
            obs_trace.record("counter", "catalog.bytes", off + ev_t, 0.0,
                             worker="cat", track="sim", value=cat_used)

    end = max(max(complete_t, default=0.0), max(writer_free, default=0.0))
    if tr:
        emit("round", f"round{obs_trace.current_round()}", 0.0, end, "sim")
        obs_trace.set_sim_offset(off + end)
    return SimReport(
        end_to_end=end,
        compute_seconds=compute_total,
        blocking_read_seconds=blocking_read,
        blocking_write_seconds=blocking_write,
        background_write_seconds=background_write,
        peak_catalog_bytes=cat_peak,
        catalog_hits=hits,
        timeline=timeline,
        critical_path_seconds=max(cp, default=0.0),
        n_workers=k,
    )
