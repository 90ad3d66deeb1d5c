"""Multi-host partition refresh with per-host memory budgets and fault-
tolerant re-dispatch (DESIGN.md §13).

The partition layer (DESIGN.md §7) made each ``(mv, partition)`` its own
DAG node with co-partitioned edges only; this module spreads those nodes
over a pool of process-level hosts sharing one ``DiskStore`` directory.
Because placement is per *partition* and edges never cross partitions, the
expanded DAG decomposes into disjoint per-host sub-DAGs: each host runs its
own in-order + window-k dispatch discipline (``engine.SubSchedule``) over
its own ``Plan``, feasible under its *own* Memory Catalog budget
(``core.altopt.solve_multihost`` — per-host budgets are separate knapsack
constraints). One host degenerates to today's single-host system.

Topology and protocol:

* ``HostPool`` — H workers (``multiprocessing`` fork processes by default;
  an in-process thread backend for deterministic fault tests). Workers run
  ``IncrementalEngine``'s refresh hooks unchanged but publish through the
  split write/commit path: they durably write part *files*
  (``DiskStore.write_part_file``), while the coordinator is the sole
  manifest committer (``commit_part``). Part ids are assigned by the
  coordinator at dispatch, so a replayed task rewrites the same part file
  and recovery is idempotent — per-partition atomic commits make replay
  safe.
* fault tolerance (``runtime.ft``) — the coordinator EWMAs per-host task
  durations through ``StragglerDetector``; a flagged host stops receiving
  work and its not-yet-durable partitions are speculatively re-dispatched
  mid-round to surviving hosts (first durable result wins; a duplicate that
  arrives with a Memory Catalog admission is released immediately, so
  ``used_bytes`` never leaks). A host that dies — detected by process exit
  or injected via ``FaultPlan`` — has its catalog entries dropped and its
  remaining partitions replayed on the least-loaded survivors, parents
  gated on durability. ``PreemptionHandler`` gives workers a cooperative
  drain: SIGTERM flushes the write-behind queue, reports, and exits 0; the
  coordinator treats it like a graceful loss.
* observability — workers ship their spans back with each message and the
  coordinator re-records them under ``track="host{h}"``, so one Perfetto
  export overlays every host's timeline; re-dispatch decisions are
  ``redispatch`` instants on the receiving host's track.

Layer contract: multi-host refresh changes *where* partitions execute,
never their bytes — with any fault schedule that leaves at least one host
alive, stored MVs are bitwise identical to the fault-free single-host run
(``tests/test_torch_multihost.py`` holds this against the JAX package's
single-host store across seeds × hosts × update kinds), and no
interleaving exceeds any host's byte budget.

The counterpart of ``repro.mv.multihost`` on PyTorch. Each host computes on
its tables as tensors on the coordinator store's device; the queues carry
metadata only (statuses, schemas, durations, commit tuples, spans and launch
counts), never a tensor. On the card the process backend forks its hosts,
and a forked child can use CUDA only if its parent never initialised it: a
``HostPool(backend="process")`` refuses to start in a process that has, so
the rule is one pool per fresh process whose coordinator has not touched
CUDA before the pool forks (a pool whose store lies on the CPU forks
anywhere). Each forked host counts its own kernel launches
(``dataplane.launches`` live per process) and ships them with its round
stats (``HostRoundStats.launches``).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue as queue_mod
import signal
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import torch

from ..core.altopt import MultiHostPlan, serial_plan, solve_multihost
from ..core.speedup import APPENDED, DELTA, STATIC, CostModel
from ..obs import trace as obs_trace
from ..runtime.ft import PreemptionHandler, StragglerDetector
from . import dataplane
from . import tableops as T
from .engine import SubSchedule, _Counters, _RunState
from .incremental import (
    FallbackRateEwma,
    IncrementalEngine,
    _retracts,
    round_view,
)
from .partition import (
    expand_update_spec,
    partition_static_fn,
    partition_workload,
)
from .storage import DiskStore, _tombstone_bytes_of, table_nbytes
from .workloads import UpdateSpec, Workload

__all__ = [
    "FaultAction",
    "FaultPlan",
    "StragglerConfig",
    "HostPool",
    "HostRoundStats",
    "Redispatch",
    "MultiHostRoundReport",
    "MultiHostScenarioReport",
    "place_partitions",
    "run_multihost_scenario",
]


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One injected fault in a worker's task loop.

    * ``kill``    — the host dies after finishing (but before reporting) its
      ``after_tasks``-th task of round ``round_idx``: ``os._exit`` on the
      process backend, a simulated death that leaves the catalog populated
      on the thread backend (the accounting-leak regression surface).
    * ``delay``   — every task from the trigger on sleeps ``seconds`` first,
      pushing the host past the straggler threshold.
    * ``preempt`` — the host receives its own SIGTERM right after enqueuing
      the trigger task's write-behind; the next task message finds the
      ``PreemptionHandler`` flag set, drains the writer, reports
      ``preempted`` and exits 0 (the cooperative-drain path).
    """

    kind: str  # "kill" | "delay" | "preempt"
    host: int
    round_idx: int = 1
    after_tasks: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    actions: tuple[FaultAction, ...] = ()

    def for_host(self, host: int) -> tuple[FaultAction, ...]:
        return tuple(a for a in self.actions if a.host == host)


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    """Coordinator-side straggler policy (feeds ``ft.StragglerDetector``).

    Every ``interval`` seconds the coordinator observes, per host, the
    larger of its last task duration and its oldest in-flight task's
    elapsed time (so a hung host keeps accumulating signal); hosts flagged
    by the detector stop receiving work and, when ``speculate``, have their
    pending partitions duplicated onto the survivors."""

    threshold: float = 3.0
    patience: int = 3
    ewma: float = 0.5
    interval: float = 0.05
    speculate: bool = True


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def place_partitions(
    n_partitions: int,
    n_hosts: int,
    bytes_per_partition: Sequence[float] | None = None,
    strategy: str = "hash",
) -> tuple[int, ...]:
    """Partition → host placement.

    ``"hash"`` (default): partition ``p`` on host ``p % H`` — balanced for
    uniform keys. ``"bytes"``: greedy bytes-balanced — partitions sorted by
    descending bytes (ties: lowest partition id) are assigned to the
    least-loaded host (ties: lowest host id), evening out the Zipf-skewed
    partition sizes ``realize_workload(key_skew=...)`` produces."""
    P = max(int(n_partitions), 1)
    H = max(int(n_hosts), 1)
    if strategy == "hash" or bytes_per_partition is None:
        if strategy == "bytes" and bytes_per_partition is None:
            raise ValueError("bytes placement needs bytes_per_partition")
        return tuple(p % H for p in range(P))
    if strategy != "bytes":
        raise ValueError(f"unknown placement strategy {strategy!r}")
    if len(bytes_per_partition) != P:
        raise ValueError(
            f"bytes_per_partition covers {len(bytes_per_partition)} "
            f"partitions, expected {P}"
        )
    load = [0.0] * H
    placement = [0] * P
    order = sorted(range(P), key=lambda p: (-float(bytes_per_partition[p]), p))
    for p in order:
        h = min(range(H), key=lambda i: (load[i], i))
        placement[p] = h
        load[h] += float(bytes_per_partition[p])
    return tuple(placement)


def partition_bytes(workload: Workload, n_partitions: int) -> list[float]:
    """Modeled bytes per partition of a P-way expanded workload (node
    ``v*P+p`` is partition ``p`` of base node ``v``) — the byte vector
    ``place_partitions(strategy="bytes")`` balances."""
    P = max(int(n_partitions), 1)
    out = [0.0] * P
    for i, node in enumerate(workload.nodes):
        out[i % P] += float(node.size)
    return out


# ---------------------------------------------------------------------------
# Host-side worker
# ---------------------------------------------------------------------------

class _FaultKill(BaseException):
    """Thread-backend simulated host death (never caught by task code)."""


class _HostEngine(IncrementalEngine):
    """Per-host execution engine: ``IncrementalEngine``'s refresh semantics
    with split write/commit publication. The worker durably writes part
    files under coordinator-assigned ids and reports commit records; only
    the coordinator mutates the shared manifest."""

    def __init__(self, workload, store, budget, spec):
        super().__init__(workload, store, budget, spec)
        self.task_part_id = -1
        self.task_flagged = True  # False for re-dispatched recovery tasks
        self.out_commit: tuple | None = None  # sync-written, ready to commit
        self.out_bg: tuple | None = None      # (name, part_id, table, commit)
        self.out_admitted = False

    def begin_task(self, part_id: int, allow_flag: bool) -> None:
        self.task_part_id = int(part_id)
        self.task_flagged = bool(allow_flag)
        self.out_commit = None
        self.out_bg = None
        self.out_admitted = False

    def _emit(self, v: int, name: str, table, commit, rt) -> None:
        """Admit + write-behind when flagged and it fits (recovery tasks
        always write synchronously — computed implies durable, so replay
        never depends on a second host's catalog), else a sync part write;
        either way the manifest commit happens at the coordinator."""
        size = max(T.table_sizes(table))
        if (
            self.task_flagged
            and v in rt.flagged
            and rt.catalog.try_put(name, table, size)
        ):
            self.out_admitted = True
            self.out_bg = (name, self.task_part_id, table, commit)
        else:
            if self.task_flagged and v in rt.flagged:
                rt.stats.overflowed(name)
            with obs_trace.span("write.sync", name):
                self.store.write_part_file(name, self.task_part_id, table)
            self.out_commit = commit

    def _publish_delta(self, v: int, delta, rt) -> None:
        node = self.workload.nodes[v]
        self._remember_schema(node.name, T.strip_weight(delta))
        if self._rows(delta) == 0 and self.store.exists(node.name):
            self.statuses[v] = STATIC  # empty delta: output is unchanged
            return
        retracts = _retracts(delta)
        self.statuses[v] = DELTA if retracts else APPENDED
        append = self.store.parts(node.name) > 0
        commit = (
            node.name, self.task_part_id, table_nbytes(delta), append,
            _tombstone_bytes_of(delta) if append else 0,
        )
        self._emit(v, node.name, delta, commit, rt)

    def _publish(self, v: int, out, rt) -> None:
        # full replacing write (used directly and via _publish_replace)
        node = self.workload.nodes[v]
        commit = (node.name, self.task_part_id, table_nbytes(out), False, 0)
        self._emit(v, node.name, out, commit, rt)


class _HostWorker:
    """One host's control loop: executes coordinator-issued tasks through
    ``_HostEngine``, drives a one-thread write-behind drain, honors the
    ``FaultPlan``, and drains cooperatively on preemption. Runs as a forked
    process (``backend="process"``) or an in-process thread.

    ``resq`` is where its messages go: the coordinator's own queue on the
    thread backend; on the process backend the write end of a pipe of its
    own, sent to synchronously under a lock of this process. A forked host
    that dies mid-send (``os._exit``) thus holds nothing another host
    waits on: a queue shared by the hosts would leave its writers' shared
    lock held, and every other host's messages stuck behind it."""

    def __init__(self, host_id, ctl, resq, workload, store_args, budget,
                 spec, faults, backend, trace_on):
        self.host = int(host_id)
        self.ctl = ctl
        self.resq = resq
        self.workload = workload
        self.store_args = dict(store_args)
        self.budget = float(budget)
        self.spec = spec
        self.faults = tuple(faults)
        self.backend = backend
        self.trace_on = bool(trace_on)
        self.dead = threading.Event()  # thread-backend liveness flag
        self.engine: _HostEngine | None = None
        self.ph = PreemptionHandler((signal.SIGTERM,))
        self._send_lock = threading.Lock()  # the loop and the write-behind thread

    def _send(self, msg: tuple) -> None:
        if self.backend == "process":
            with self._send_lock:
                self.resq.send(msg)
        else:
            self.resq.put(msg)

    # -- span shipping -------------------------------------------------------
    def _spans(self) -> list:
        # process backend: drain this process's buffer and ship; thread
        # backend: spans land in the shared buffer directly (draining it
        # would steal the coordinator's own spans)
        if self.backend == "process" and self.trace_on:
            return obs_trace.drain()
        return []

    # -- faults --------------------------------------------------------------
    def _fault(self, kind: str, round_idx: int, tasks_done: int):
        for i, a in enumerate(self.faults):
            if i in self._fired or a.kind != kind:
                continue
            if a.round_idx == round_idx and tasks_done >= a.after_tasks:
                self._fired.add(i)
                return a
        return None

    def _die(self) -> None:
        """Host death: hard exit (process) or simulated (thread — the loop
        stops consuming, the catalog keeps its entries, and the coordinator
        must drop them: the accounting-leak regression surface)."""
        if self.backend == "process":
            os._exit(13)
        raise _FaultKill()

    def _preempt_self(self) -> None:
        if self.backend == "process":
            os.kill(os.getpid(), signal.SIGTERM)  # handler sets the flag
        else:
            self.ph._on_signal(signal.SIGTERM, None)

    # -- main loop -----------------------------------------------------------
    def run(self) -> None:
        if self.backend == "process":
            # forked child: drop the parent's span buffer copy (it already
            # owns those spans) and install the cooperative-drain handler;
            # the monotonic trace origin is shared, so child timestamps
            # overlay the coordinator's directly
            obs_trace.enable(self.trace_on)
            obs_trace.clear()
            self.ph.install()
            # H forked hosts share the machine's cores, and OpenMP's pool
            # is not fork-safe: a host's CPU-side torch work runs on one
            # thread, as torch's own DataLoader workers do
            torch.set_num_threads(1)
        store = DiskStore(**self.store_args)
        engine = _HostEngine(self.workload, store, self.budget, self.spec)
        self.engine = engine
        writer = ThreadPoolExecutor(max_workers=1)
        self._fired: set[int] = set()
        try:
            self._loop(store, engine, writer)
        except _FaultKill:
            self.dead.set()  # catalog intentionally left populated
            return
        except BaseException:
            self._send(("error", self.host, traceback.format_exc()))
        finally:
            if not self.dead.is_set():
                writer.shutdown(wait=True)

    def _bg_write(self, store, name, part_id, table, commit, v):
        try:
            with obs_trace.span("write.behind", name):
                store.write_part_file(name, part_id, table)
            self._send(("durable", self.host, v, commit, self._spans()))
        except Exception:
            self._send(("error", self.host, traceback.format_exc()))

    def _round_launches(self, launches0: dict[str, int]) -> dict[str, int]:
        # a forked host's own launches this round; on the thread backend
        # every host counts into the coordinator's registry, which holds them
        if self.backend != "process":
            return {}
        return {k: n - launches0.get(k, 0)
                for k, n in _launch_counts().items()}

    def _loop(self, store, engine, writer) -> None:
        rt: _RunState | None = None
        launches0: dict[str, int] = {}
        pending: list = []
        tasks_done = 0
        delay_s = 0.0
        while True:
            msg = self.ctl.get()
            kind = msg[0]
            if kind == "round":
                _, r, static_ids, force_full_ids, parts0, flagged_ids = msg
                engine.catalog.clear()
                engine.round_idx = r
                engine._static = frozenset(static_ids)
                engine._force_full = frozenset(force_full_ids)
                engine.statuses = {v: STATIC for v in static_ids}
                engine._parts0 = dict(parts0)
                engine.join_fallbacks = 0
                engine.fb_affected = 0
                engine.fb_matched = 0
                store.invalidate_cache()
                if self.backend == "process":
                    obs_trace.set_round(r)
                rt = _RunState(
                    catalog=engine.catalog, stats=_Counters(), writer=writer,
                    write_futures=[], wf_lock=threading.Lock(),
                    flagged=frozenset(flagged_ids), t0=time.perf_counter(),
                )
                tasks_done = 0
                delay_s = 0.0
                launches0 = _launch_counts()
            elif kind == "task":
                _, v, part_id, parent_meta, own_schema, allow_flag = msg
                if self.ph.preempted:
                    # cooperative drain: every enqueued write-behind becomes
                    # durable (and reported) before the coordinator learns
                    # we are gone, then exit 0 for a clean restart
                    for f in pending:
                        f.result()
                    self._send(("preempted", self.host, self._spans()))
                    return
                a = self._fault("delay", engine.round_idx, tasks_done)
                if a is not None:
                    delay_s = a.seconds
                if delay_s:
                    time.sleep(delay_s)
                node = self.workload.nodes[v]
                for p, (status, schema) in parent_meta.items():
                    engine.statuses[p] = status
                    if schema:
                        engine.schemas[self.workload.nodes[p].name] = schema
                if own_schema:
                    engine.schemas[node.name] = own_schema
                store.invalidate_cache()  # see coordinator-committed parents
                engine.begin_task(part_id, allow_flag)
                t0 = time.perf_counter()
                with obs_trace.span("task", node.name):
                    engine._exec_node(v, rt)
                dt = time.perf_counter() - t0
                if self._fault("kill", engine.round_idx, tasks_done):
                    self._die()  # mid-round: computed but never reported
                tasks_done += 1
                self._send((
                    "computed", self.host, v, engine.statuses.get(v),
                    engine.schemas.get(node.name), dt, engine.out_commit,
                    engine.out_admitted, engine.out_bg is not None,
                    self._spans(),
                ))
                if engine.out_bg is not None:
                    nm, pid, tbl, cm = engine.out_bg
                    pending.append(writer.submit(
                        self._bg_write, store, nm, pid, tbl, cm, v
                    ))
                if self._fault("preempt", engine.round_idx, tasks_done):
                    self._preempt_self()  # "during write-behind"
            elif kind == "release":
                engine.catalog.release(msg[1])
            elif kind == "round_end":
                for f in pending:
                    f.result()
                pending.clear()
                self._send(("round_stats", self.host, dict(
                    used_bytes=engine.catalog.used_bytes,
                    peak_bytes=engine.catalog.peak_bytes,
                    hits=rt.stats.hits if rt else 0,
                    misses=rt.stats.misses if rt else 0,
                    overflow=rt.stats.overflow if rt else 0,
                    fb_affected=engine.fb_affected,
                    fb_matched=engine.fb_matched,
                    join_fallbacks=engine.join_fallbacks,
                    launches=self._round_launches(launches0),
                ), self._spans()))
            elif kind == "stop":
                return


def _launch_counts() -> dict[str, int]:
    """This process's data-plane launch counts, variants included."""
    return {**dataplane.launches, **dataplane.variant_launches}


def _worker_entry(worker: "_HostWorker") -> None:
    worker.run()


def _pump(rx, out: queue_mod.Queue) -> None:
    """Forward one forked host's messages into the coordinator's queue until
    the host's end of the pipe closes (it exited or died)."""
    while True:
        try:
            msg = rx.recv()
        except (EOFError, OSError):
            return
        out.put(msg)


# ---------------------------------------------------------------------------
# Coordinator reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Redispatch:
    """One task moved off a flagged/lost host mid-round."""

    node: str
    from_host: int
    to_host: int
    reason: str  # "dead" | "preempted" | "straggler"


@dataclasses.dataclass
class HostRoundStats:
    host: int
    executed: int = 0
    peak_catalog_bytes: float = 0.0
    used_bytes: float = 0.0
    catalog_hits: int = 0
    disk_reads: int = 0
    overflow: int = 0
    alive: bool = True
    # the host's data-plane kernel launches this round (``kernel`` and
    # ``kernel/variant`` as ``dataplane`` counts them), shipped by a forked
    # host; empty on the thread backend, whose hosts count into the
    # coordinator's own registry
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MultiHostRoundReport:
    round_idx: int
    mode: str
    plan: MultiHostPlan
    elapsed: float
    statuses: dict[str, str]
    host_stats: list[HostRoundStats]
    redispatches: list[Redispatch]
    straggler_events: list
    hosts_lost: list[int]
    sizes: tuple[float, ...] = ()
    fb_affected: int = 0
    fb_matched: int = 0
    join_fallbacks: int = 0

    @property
    def peak_catalog_bytes(self) -> float:
        return max((s.peak_catalog_bytes for s in self.host_stats), default=0.0)


@dataclasses.dataclass
class MultiHostScenarioReport:
    workload: str
    spec: UpdateSpec
    n_hosts: int
    placement: tuple[int, ...]
    rounds: list[MultiHostRoundReport]
    backend: str = ""  # the pool's: "process" or "thread"

    @property
    def build_seconds(self) -> float:
        return self.rounds[0].elapsed if self.rounds else 0.0

    @property
    def refresh_seconds(self) -> float:
        return sum(r.elapsed for r in self.rounds[1:])

    @property
    def redispatches(self) -> list[Redispatch]:
        return [rd for r in self.rounds for rd in r.redispatches]

    @property
    def hosts_lost(self) -> list[int]:
        return sorted({h for r in self.rounds for h in r.hosts_lost})

    @property
    def launches(self) -> dict[str, int]:
        """Kernel launches the forked hosts shipped, summed over rounds and
        hosts (a host that died mid-round never ships that round's)."""
        out: dict[str, int] = {}
        for r in self.rounds:
            for hs in r.host_stats:
                for k, n in hs.launches.items():
                    out[k] = out.get(k, 0) + n
        return out


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------

SHUTDOWN_GRACE = 3.0  # seconds a stopped host has to end before SIGTERM


class HostPool:
    """Coordinator over H host workers sharing one ``DiskStore`` directory.

    Owns the only manifest-committing store handle, the per-host
    ``SubSchedule`` dispatch disciplines, part-id assignment, catalog
    release bookkeeping, straggler detection, and fault re-dispatch. One
    ``run_round`` executes one refresh round of a ``MultiHostPlan`` to
    durability (the round SLA holds per host: a round ends only when every
    refreshed MV is committed)."""

    def __init__(
        self,
        workload: Workload,
        store: DiskStore,
        host_budgets: Sequence[float],
        spec: UpdateSpec,
        n_workers_per_host: int = 1,
        backend: str = "process",
        fault_plan: FaultPlan | None = None,
        straggler: StragglerConfig | None = None,
        round_timeout: float = 120.0,
    ):
        if backend not in ("process", "thread"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "process" and "fork" not in mp.get_all_start_methods():
            backend = "thread"  # platforms without fork: closures don't pickle
        if (backend == "process" and store.device.type == "cuda"
                and torch.cuda.is_initialized()):
            raise RuntimeError(
                "HostPool(backend='process') forks its hosts, and this process "
                "has initialised CUDA: a forked child cannot use the card. "
                "Start the pool in a fresh process whose coordinator has not "
                "touched CUDA (one pool per process), or pass backend='thread'"
            )
        self.workload = workload
        self.store = store
        self.budgets = tuple(float(b) for b in host_budgets)
        self.n_hosts = len(self.budgets)
        self.spec = spec
        self.k = max(int(n_workers_per_host), 1)
        self.backend = backend
        self.fault_plan = fault_plan or FaultPlan()
        self.cfg = straggler or StragglerConfig()
        self.round_timeout = float(round_timeout)
        self.names = [n.name for n in workload.nodes]
        self.parents = [tuple(n.parents) for n in workload.nodes]
        self.children: list[list[int]] = [[] for _ in range(workload.n)]
        for i, node in enumerate(workload.nodes):
            for p in node.parents:
                self.children[p].append(i)
        self._schemas: dict[str, Any] = {}  # name -> {col: dtype}, all rounds
        store_args = dict(
            root=store.root, read_bw=store.read_bw,
            write_bw=store.write_bw, latency=store.latency,
            device=store.device,
        )
        ctx = mp.get_context("fork") if backend == "process" else None
        # every host's messages land here: put directly by a thread host,
        # forwarded from a forked host's own pipe by a pump thread
        self.resq: queue_mod.Queue = queue_mod.Queue()
        self.hosts: list[dict] = []
        for h in range(self.n_hosts):
            ctl = ctx.Queue() if ctx else queue_mod.Queue()
            rx, tx = ctx.Pipe(duplex=False) if ctx else (None, self.resq)
            worker = _HostWorker(
                h, ctl, tx, workload, store_args, self.budgets[h],
                spec, self.fault_plan.for_host(h), backend,
                obs_trace.enabled(),
            )
            if ctx:
                proc = ctx.Process(
                    target=_worker_entry, args=(worker,), daemon=True
                )
            else:
                proc = threading.Thread(
                    target=_worker_entry, args=(worker,), daemon=True
                )
            proc.start()
            if ctx:
                tx.close()  # the host holds the only write end: EOF when it ends
            self.hosts.append(dict(
                idx=h, ctl=ctl, rx=rx, proc=proc, worker=worker, alive=True,
                dead_seen=None,
            ))
        # the pumps start once every host is forked: no fork copies a thread
        self._pumps = [
            threading.Thread(target=_pump, args=(host["rx"], self.resq), daemon=True)
            for host in self.hosts if ctx
        ]
        for t in self._pumps:
            t.start()

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        """Stop every host; returns within about ``SHUTDOWN_GRACE`` + 2 seconds.

        Live hosts get a stop message and ``SHUTDOWN_GRACE`` seconds to end. A forked
        host still running then gets SIGTERM, which only asks it to drain
        (its handler sets a flag), and a second later SIGKILL; every host is
        joined. The control queues are closed without waiting for their
        feeder threads (a dead host's pipe may be full), so nothing is left
        for the interpreter's exit to join."""
        for host in self.hosts:
            if host["alive"]:
                try:
                    host["ctl"].put(("stop",))
                except Exception:
                    pass
        deadline = time.monotonic() + SHUTDOWN_GRACE
        for host in self.hosts:
            host["proc"].join(timeout=max(0.0, deadline - time.monotonic()))
        if self.backend != "process":
            return
        for end in ("terminate", "kill"):
            live = [host["proc"] for host in self.hosts if host["proc"].is_alive()]
            for proc in live:
                getattr(proc, end)()
            for proc in live:
                proc.join(timeout=1.0)
        for host in self.hosts:
            host["ctl"].cancel_join_thread()
            host["ctl"].close()
        for t in self._pumps:  # every host has ended: each pipe is at EOF
            t.join(timeout=1.0)
        for host in self.hosts:
            host["rx"].close()

    def host_catalog_used(self, h: int) -> float:
        """Thread backend only: the host engine's live catalog occupancy
        (the accounting-leak regression probe)."""
        eng = self.hosts[h]["worker"].engine
        return eng.catalog.used_bytes if eng is not None else 0.0

    def _host_dead(self, host: dict) -> bool:
        proc = host["proc"]
        if self.backend == "thread":
            return host["worker"].dead.is_set()
        code = proc.exitcode
        if code is None:
            host["dead_seen"] = None
            return False
        if code != 0:
            return True
        # exit 0: a preempted/stopped worker — give its final message one
        # second to arrive before declaring the host dead
        if host["dead_seen"] is None:
            host["dead_seen"] = time.monotonic()
        return time.monotonic() - host["dead_seen"] > 1.0

    # -- one round -----------------------------------------------------------
    def run_round(
        self,
        round_idx: int,
        plan: MultiHostPlan,
        static: Sequence[int] = (),
        force_full: Sequence[int] = (),
        sizes: Sequence[float] = (),
        mode: str = "",
    ) -> MultiHostRoundReport:
        n = self.workload.n
        P = plan.n_partitions
        static_set = frozenset(static)
        cfg = self.cfg
        obs_trace.set_round(round_idx)
        tr0 = obs_trace.now()
        t0 = time.perf_counter()

        # -- round state ------------------------------------------------------
        scheds: dict[int, SubSchedule] = {}
        owner: dict[int, int] = {}
        flagged_of: dict[int, frozenset] = {}
        for h in range(self.n_hosts):
            order = list(plan.host_order(h))
            flagged_of[h] = plan.host_flagged(h)
            for v in order:
                owner[v] = h
            scheds[h] = SubSchedule(order, n_workers=self.k)
        computed: set[int] = set(static_set)
        durable: set[int] = set(static_set)
        committed: set[int] = set()
        counted: set[int] = set()
        recovery: set[int] = set()
        statuses: dict[int, str] = {v: STATIC for v in static_set}
        admitted_by: dict[int, int] = {}
        assigned_part: dict[int, int] = {}
        pending = [
            sum(1 for c in self.children[v] if c not in static_set)
            for v in range(n)
        ]
        inflight: dict[int, dict[int, float]] = {
            h: {} for h in range(self.n_hosts)
        }
        # tasks sent minus results received, per host — a straggler's late
        # result must be processed (and its admission released) before that
        # host's round_end, or its stats would snapshot a phantom resident
        outstanding = [0] * self.n_hosts
        last_dur: dict[int, float | None] = {
            h: None for h in range(self.n_hosts)
        }
        suspect: set[int] = set()
        redispatches: list[Redispatch] = []
        hosts_lost: list[int] = []
        exec_count = [0] * self.n_hosts
        round_stats: dict[int, dict] = {}
        fb = dict(fb_affected=0, fb_matched=0, join_fallbacks=0)
        detector = StragglerDetector(
            self.n_hosts, threshold=cfg.threshold, patience=cfg.patience,
            ewma=cfg.ewma,
        )
        for sched in scheds.values():
            for v in static_set:
                sched.complete(v)

        parts0 = {name: self.store.parts(name) for name in self.names}
        for host in self.hosts:
            if host["alive"]:
                host["ctl"].put((
                    "round", round_idx, sorted(static_set),
                    sorted(force_full), parts0,
                    sorted(flagged_of[host["idx"]]),
                ))

        # -- helpers ----------------------------------------------------------
        def alive(h: int) -> bool:
            return self.hosts[h]["alive"]

        def ship_spans(h: int, spans) -> None:
            for s in spans:
                obs_trace.record(
                    s.cat, s.name, s.ts, s.dur, nbytes=s.nbytes,
                    worker=s.worker, track=f"host{h}", value=s.value,
                    round_idx=s.round,
                )

        def send_release(h: int, v: int) -> None:
            if alive(h):
                self.hosts[h]["ctl"].put(("release", self.names[v]))

        def maybe_release(p: int) -> None:
            if pending[p] <= 0 and p in admitted_by:
                send_release(admitted_by.pop(p), p)

        def part_id_of(v: int) -> int:
            if v not in assigned_part:
                assigned_part[v] = self.store.next_part_id(self.names[v])
            return assigned_part[v]

        def parent_ok_for(h: int):
            def ok(v: int) -> bool:
                if v in recovery:
                    # replay reads only durable content — the dead host's
                    # catalog copies are gone
                    return all(p in durable for p in self.parents[v])
                return all(
                    p in durable
                    or (p in computed and admitted_by.get(p) == h)
                    for p in self.parents[v]
                )
            return ok

        def load_of(h: int) -> int:
            return len(scheds[h].unissued()) + len(inflight[h])

        def redispatch_from(h: int, reason: str) -> None:
            rem = [
                v for v in scheds[h].order
                if owner.get(v) == h and v not in durable
                and v not in computed and v not in static_set
            ]
            inflight[h].clear()
            if not rem:
                return
            targets = [
                g for g in range(self.n_hosts)
                if g != h and alive(g) and g not in suspect
            ]
            if not targets:
                raise RuntimeError(
                    f"host {h} {reason} with no surviving host to take "
                    f"{len(rem)} tasks"
                )
            by_part: dict[int, list[int]] = {}
            for v in rem:
                by_part.setdefault(v % P, []).append(v)
            for vs in by_part.values():
                g = min(targets, key=lambda t: (load_of(t), t))
                for v in vs:
                    owner[v] = g
                    recovery.add(v)
                    scheds[g].reopen(v)
                    redispatches.append(
                        Redispatch(self.names[v], h, g, reason)
                    )
                    obs_trace.record(
                        "redispatch", self.names[v], obs_trace.now(), 0.0,
                        worker="coord", track=f"host{g}",
                    )
                scheds[g].extend(vs)

        def on_host_lost(h: int, reason: str) -> None:
            if not alive(h):
                return
            self.hosts[h]["alive"] = False
            hosts_lost.append(h)
            suspect.discard(h)
            # catalog entries of the lost host are dropped: bookkeeping
            # here, and the object itself on the thread backend (a forked
            # process's catalog dies with it)
            for v in [v for v, ah in admitted_by.items() if ah == h]:
                admitted_by.pop(v)
            if self.backend == "thread":
                eng = self.hosts[h]["worker"].engine
                if eng is not None:
                    eng.catalog.clear()
            # computed-but-not-durable work died with the host: roll it
            # back so replay re-executes it
            for v in [
                v for v in computed
                if owner.get(v) == h and v not in durable
                and v not in static_set
            ]:
                computed.discard(v)
                for sched in scheds.values():
                    sched.reopen(v)
            redispatch_from(h, reason)

        def on_computed(h, v, status, schema, dt, commit, admitted, has_bg):
            inflight[h].pop(v, None)
            outstanding[h] -= 1
            last_dur[h] = dt
            first = v not in computed and v not in durable
            if first:
                computed.add(v)
                statuses[v] = status
                if schema:
                    self._schemas[self.names[v]] = schema
                exec_count[h] += 1
                for sched in scheds.values():
                    sched.complete(v)
            if admitted:
                if first and owner.get(v) == h:
                    admitted_by[v] = h
                else:
                    # duplicate result, or a task already moved off this
                    # host: nothing will ever read this catalog entry —
                    # release it now or the host's used_bytes leaks
                    send_release(h, v)
            if commit is not None and v not in committed:
                self.store.commit_part(*commit)
                committed.add(v)
                durable.add(v)
                for sched in scheds.values():
                    sched.complete(v)
            if first and commit is None and not has_bg:
                durable.add(v)  # empty delta: stored content already exact
            if first and v not in counted:
                counted.add(v)
                for p in self.parents[v]:
                    pending[p] -= 1
                    maybe_release(p)
                maybe_release(v)

        def on_durable(h, v, commit):
            if v not in committed:
                self.store.commit_part(*commit)
                committed.add(v)
                durable.add(v)
                for sched in scheds.values():
                    sched.complete(v)
            # else: a speculative duplicate already committed this part

        def handle(msg) -> None:
            kind = msg[0]
            if kind == "computed":
                _, h, v, status, schema, dt, commit, admitted, has_bg, sp = msg
                ship_spans(h, sp)
                on_computed(h, v, status, schema, dt, commit, admitted, has_bg)
            elif kind == "durable":
                _, h, v, commit, sp = msg
                ship_spans(h, sp)
                on_durable(h, v, commit)
            elif kind == "preempted":
                _, h, sp = msg
                ship_spans(h, sp)
                on_host_lost(h, "preempted")
            elif kind == "round_stats":
                _, h, stats, sp = msg
                ship_spans(h, sp)
                round_stats[h] = stats
            elif kind == "error":
                raise RuntimeError(f"host {msg[1]} failed:\n{msg[2]}")

        def issue_all() -> None:
            for h in range(self.n_hosts):
                if not alive(h) or h in suspect:
                    continue
                sched = scheds[h]
                ok = parent_ok_for(h)
                while len(inflight[h]) < self.k:
                    v = sched.next_ready(ok)
                    if v is None:
                        break
                    sched.issue()
                    parent_meta = {
                        p: (
                            statuses.get(p, STATIC),
                            self._schemas.get(self.names[p]),
                        )
                        for p in self.parents[v]
                    }
                    self.hosts[h]["ctl"].put((
                        "task", v, part_id_of(v), parent_meta,
                        self._schemas.get(self.names[v]), v not in recovery,
                    ))
                    inflight[h][v] = time.monotonic()
                    outstanding[h] += 1

        step = 0
        last_obs = time.monotonic()

        def straggler_tick() -> None:
            nonlocal step, last_obs
            now = time.monotonic()
            if now - last_obs < cfg.interval:
                return
            last_obs = now
            sig: dict[int, float] = {}
            for h in range(self.n_hosts):
                if not alive(h):
                    continue
                s = last_dur[h]
                if inflight[h]:
                    oldest = min(inflight[h].values())
                    s = max(s or 0.0, now - oldest)
                if s is not None:
                    sig[h] = max(s, 1e-9)
            live = [h for h in range(self.n_hosts) if alive(h)]
            if len(live) < 2 or len(sig) < len(live):
                return  # not every live host has a signal yet
            neutral = sum(sig.values()) / len(sig)
            durations = [
                sig.get(h, neutral) if alive(h) else neutral
                for h in range(self.n_hosts)
            ]
            step += 1
            for h in detector.observe(step, durations):
                if not alive(h) or h in suspect or not cfg.speculate:
                    continue
                if not any(
                    alive(g) and g not in suspect and g != h
                    for g in range(self.n_hosts)
                ):
                    continue  # nowhere to move the work
                suspect.add(h)
                redispatch_from(h, "straggler")

        # a host lost in an earlier round stays lost: its placement slice is
        # re-dispatched to survivors up front, before the first issue
        for h in range(self.n_hosts):
            if not alive(h) and scheds[h].order:
                redispatch_from(h, "dead")

        # -- dispatch loop ----------------------------------------------------
        deadline = time.monotonic() + self.round_timeout
        while len(durable | static_set) < n:
            for host in self.hosts:
                if host["alive"] and self._host_dead(host):
                    on_host_lost(host["idx"], "dead")
            issue_all()
            try:
                msg = self.resq.get(timeout=0.02)
            except queue_mod.Empty:
                msg = None
            while msg is not None:
                handle(msg)
                try:
                    msg = self.resq.get_nowait()
                except queue_mod.Empty:
                    msg = None
            straggler_tick()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"round {round_idx} timed out after "
                    f"{self.round_timeout:.0f}s with "
                    f"{n - len(durable | static_set)} tasks not durable"
                )

        # -- round end: collect per-host stats --------------------------------
        # a host's round_end is sent only after every task it was issued has
        # been answered (a straggler's late duplicate may still be in flight
        # after the round is durable) — per-host ctl FIFO then guarantees
        # its releases land before the stats snapshot
        ended: set[int] = set()
        while True:
            for host in self.hosts:
                if host["alive"] and self._host_dead(host):
                    on_host_lost(host["idx"], "dead")
            live = [h for h in range(self.n_hosts) if alive(h)]
            for h in live:
                if h not in ended and outstanding[h] == 0:
                    self.hosts[h]["ctl"].put(("round_end",))
                    ended.add(h)
            if all(h in round_stats for h in live):
                break
            try:
                handle(self.resq.get(timeout=0.05))
            except queue_mod.Empty:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"round {round_idx}: stats collection timed out"
                )

        host_stats = []
        for h in range(self.n_hosts):
            st = round_stats.get(h, {})
            host_stats.append(HostRoundStats(
                host=h,
                executed=exec_count[h],
                peak_catalog_bytes=float(st.get("peak_bytes", 0.0)),
                used_bytes=float(st.get("used_bytes", 0.0)),
                catalog_hits=int(st.get("hits", 0)),
                disk_reads=int(st.get("misses", 0)),
                overflow=int(st.get("overflow", 0)),
                alive=alive(h),
                launches=dict(st.get("launches", {})),
            ))
            for key in fb:
                fb[key] += int(st.get(key, 0))
        elapsed = time.perf_counter() - t0
        if obs_trace.enabled():
            obs_trace.record(
                "round", f"round{round_idx}", tr0, obs_trace.now() - tr0,
                worker="coord",
            )
        return MultiHostRoundReport(
            round_idx=round_idx,
            mode=mode or ("build" if round_idx == 0 else self.spec.mode),
            plan=plan,
            elapsed=elapsed,
            statuses={
                self.names[v]: s for v, s in sorted(statuses.items())
            },
            host_stats=host_stats,
            redispatches=redispatches,
            straggler_events=list(detector.events),
            hosts_lost=hosts_lost,
            sizes=tuple(sizes),
            fb_affected=fb["fb_affected"],
            fb_matched=fb["fb_matched"],
            join_fallbacks=fb["join_fallbacks"],
        )


# ---------------------------------------------------------------------------
# Scenario driver
# ---------------------------------------------------------------------------

def _serial_multihost(graph, budgets, n_partitions, placement) -> MultiHostPlan:
    """No-opt multi-host plan: per-host topological order, nothing flagged."""
    P = max(int(n_partitions), 1)
    host_plans, host_nodes = [], []
    for parts, keep in graph.host_slices(P, placement):
        host_plans.append(serial_plan(graph.subgraph(keep)))
        host_nodes.append(tuple(keep))
    return MultiHostPlan(
        host_plans=tuple(host_plans), host_nodes=tuple(host_nodes),
        placement=tuple(int(h) for h in placement),
        host_budgets=tuple(float(b) for b in budgets), n_partitions=P,
    )


def run_multihost_scenario(
    workload: Workload,
    n_partitions: int,
    store: DiskStore,
    host_budgets: Sequence[float],
    spec: UpdateSpec,
    cost_model: CostModel,
    shares: Sequence[float] | None = None,
    n_workers_per_host: int = 1,
    placement: str | Sequence[int] = "hash",
    backend: str = "process",
    fault_plan: FaultPlan | None = None,
    straggler: StragglerConfig | None = None,
    optimize: bool = True,
    solve_kw: dict | None = None,
    round_timeout: float = 120.0,
) -> MultiHostScenarioReport:
    """Execute a multi-round partitioned refresh scenario across H hosts.

    The workload is expanded P ways (``partition_workload``), partitions
    are placed on ``len(host_budgets)`` hosts (``placement``: ``"hash"``,
    ``"bytes"`` — greedy balanced on modeled partition bytes — or an
    explicit partition→host vector), and every round is planned with
    ``solve_multihost`` so each host's resident set fits its own budget,
    then executed by a ``HostPool`` to durability. Rounds share the
    calibrated JOIN fallback rate and the clean-partition pruner with
    ``run_scenario``, so stored bytes are identical to the single-host
    partitioned scenario — under any injected ``fault_plan`` that leaves a
    host alive."""
    stale = {n.name for n in workload.nodes} & set(store.manifest())
    if stale:
        raise ValueError(
            f"store already holds {len(stale)} of this workload's MVs "
            f"(e.g. {sorted(stale)[:3]}); scenarios must start on an empty "
            "store"
        )
    P = max(int(n_partitions), 1)
    budgets = tuple(float(b) for b in host_budgets)
    pwl, pmap = partition_workload(workload, P, shares)
    espec = expand_update_spec(spec, pmap)
    static_fn = partition_static_fn(workload, pwl, pmap, spec)
    if isinstance(placement, str):
        placement_t = place_partitions(
            P, len(budgets),
            bytes_per_partition=partition_bytes(pwl, P),
            strategy=placement,
        )
    else:
        placement_t = tuple(int(h) for h in placement)
    pool = HostPool(
        pwl, store, budgets, espec,
        n_workers_per_host=n_workers_per_host, backend=backend,
        fault_plan=fault_plan, straggler=straggler,
        round_timeout=round_timeout,
    )
    try:
        fb_ewma = FallbackRateEwma()
        rounds: list[MultiHostRoundReport] = []
        for r in range(spec.n_rounds + 1):
            view, sizes, force_full = round_view(
                pwl, espec, cost_model, r, store=store,
                fallback_rate=fb_ewma.rate,
            )
            g = view.to_graph(cost_model)
            if optimize:
                plan = solve_multihost(
                    g, budgets, P, placement=placement_t,
                    n_workers=n_workers_per_host, **(solve_kw or {}),
                )
            else:
                plan = _serial_multihost(g, budgets, P, placement_t)
            statuses = view.meta.get("update", {}).get("statuses", ())
            static = frozenset(
                i for i, s in enumerate(statuses) if s == STATIC
            )
            static = static | frozenset(static_fn(r, static))
            rep = pool.run_round(
                r, plan, static=sorted(static),
                force_full=sorted(force_full), sizes=sizes,
                mode=spec.mode if r else "build",
            )
            fb_ewma.observe(rep.fb_affected, rep.fb_matched)
            rounds.append(rep)
    finally:
        pool.shutdown()
    return MultiHostScenarioReport(
        workload=pwl.name, spec=spec, n_hosts=len(budgets),
        placement=placement_t, rounds=rounds, backend=pool.backend,
    )
