"""External storage for materialized tables (paper: NFS via Hive/Parquet).

``DiskStore`` persists tables (dicts of tensors) as ``.npz`` files with
atomic rename, an fsync'd manifest of completed materializations (the
restart/crash-recovery source of truth), and an optional bandwidth throttle so
laptop-scale experiments can reproduce the paper's NFS read/write bandwidths
(519.8 / 358.9 MB/s) or any slower tier. Throttling is keyed to the *logical*
table bytes (``table_nbytes``) in both directions, so the modeled bandwidths
apply to the same byte count the cost model and the Memory Catalog account.

Incremental refresh stores an MV as an ordered sequence of *parts* (the way
warehouses append Parquet partitions): ``write`` replaces the whole MV with
a single new part, ``append`` adds one part containing only the delta rows
(charged at delta bytes), and ``read`` *consolidates* the manifest-recorded
parts. A delta part may be a Z-set: rows carrying a ``weight`` column where
``-1`` rows are tombstones retracting the stored row with the same rid
(UPDATE = retraction + reinsertion under one rid, DELETE = bare
retraction). Consolidation happens on read — each delta part is applied in
append order (``tableops.apply_delta``: retracted rids drop out,
insertions splice back in canonical rid order) — while throttle pricing
stays keyed to the *logical bytes actually read*, tombstones included:
retraction traffic costs real I/O even though it shrinks the consolidated
result. ``consolidate`` rewrites a multi-part MV as its single live part
(atomic at the manifest commit like any write). Part files carry
immutable monotone ids and new content is always
written to an id the current manifest does not reference, so every mutation
commits atomically at the manifest update: a crash beforehand leaves the
old entry (and its intact files) authoritative, with at most an orphan part
file that readers ignore, the next write of that id overwrites, and
``delete`` sweeps.

The counterpart of ``repro.mv.storage`` with the same on-disk format: parts
are written through ``.cpu().numpy()`` and read back with ``np.load`` onto
the store's device, so a store written by either package reads in the
other.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as obs_trace
from ..obs.metrics import METRICS

Table = Mapping[str, torch.Tensor]

# Separator between an MV name and its partition id in the store namespace:
# partition ``p`` of MV ``mv3`` lives under the entry name ``mv3@p2``. Each
# partition is an independent part-file group with its own manifest entry —
# per-partition sizes, appends, and atomic commits fall out of the existing
# single-entry machinery (DESIGN.md §7).
PARTITION_SEP = "@p"


def partition_entry_name(name: str, pid: int) -> str:
    """Store-namespace name of partition ``pid`` of MV ``name``."""
    return f"{name}{PARTITION_SEP}{int(pid)}"


def split_partition_name(entry: str) -> tuple[str, int] | None:
    """Inverse of ``partition_entry_name`` (None for unpartitioned names)."""
    base, sep, pid = entry.rpartition(PARTITION_SEP)
    if not sep or not pid.isdigit():
        return None
    return base, int(pid)


def table_nbytes(table: Table) -> int:
    return int(sum(v.nbytes for v in table.values()))


def _tombstone_bytes_of(delta: Table) -> int:
    """Estimated dead bytes an appended Z-set delta part adds to an MV: the
    physical bytes of its retraction rows plus the (equal-width) stored rows
    those tombstones will cancel at the next consolidation. An estimate for
    the consolidation scheduler, not an exact ledger — the victim rows'
    payload width is taken from the delta's own schema minus the weight
    column."""
    from . import tableops as T

    n = T.n_rows(delta)
    if n == 0 or T.WEIGHT_COL not in delta:
        return 0
    w = delta[T.WEIGHT_COL].to(torch.int64)
    n_tomb = int((w < 0).sum())
    if n_tomb == 0:
        return 0
    total = table_nbytes(delta)
    payload = total - delta[T.WEIGHT_COL].nbytes
    retract_mult = int(-(w[w < 0].sum()))
    return int(round(total / n * n_tomb + payload / n * retract_mult))


class DiskStore:
    def __init__(
        self,
        root: str | os.PathLike,
        read_bw: float | None = None,
        write_bw: float | None = None,
        latency: float = 0.0,
        device: str | torch.device | None = None,
    ):
        """read_bw/write_bw in bytes/sec add throttling sleeps (None = full
        native speed); latency is the per-read seek penalty (paper: 175 µs).
        Tables read back land on ``device`` (default: the card)."""
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.read_bw = read_bw
        self.write_bw = write_bw
        self.latency = latency
        self._manifest_path = self.root / "MANIFEST.json"
        self._manifest_lock = threading.Lock()
        self._entries_cache: dict[str, dict] | None = None
        self.read_seconds = 0.0  # cumulative blocking read time (Table IV)
        self.write_seconds = 0.0
        self._io_lock = threading.Lock()

    # -- paths ----------------------------------------------------------------
    def _path(self, name: str, part_id: int = 0) -> Path:
        if part_id == 0:
            return self.root / f"{name}.npz"
        return self.root / f"{name}.part{part_id}.npz"

    def exists(self, name: str) -> bool:
        return name in self._entries()

    # -- manifest (crash-consistent completion record) -------------------------
    def _entries_locked(self) -> dict[str, dict]:
        """Parsed manifest; caller must hold ``_manifest_lock``. The lazy
        first load happens under the lock so a concurrent ``_record`` commit
        can never be clobbered by a stale snapshot read outside it."""
        if self._entries_cache is None:
            if not self._manifest_path.exists():
                self._entries_cache = {}
            else:
                raw = json.loads(self._manifest_path.read_text())
                # tolerate the legacy {name: bytes} single-part schema
                self._entries_cache = {
                    k: (v if isinstance(v, dict)
                        else {"bytes": int(v), "parts": [0]})
                    for k, v in raw.items()
                }
        return self._entries_cache

    def _entries(self) -> dict[str, dict]:
        # the store object is the sole writer of its root, so the parsed
        # manifest is cached; mutations swap in a fresh dict atomically
        # (readers on other threads always see a complete mapping)
        cache = self._entries_cache
        if cache is None:
            with self._manifest_lock:
                cache = self._entries_locked()
        return cache

    def manifest(self) -> dict[str, int]:
        """name -> total logical bytes of the materialized MV."""
        return {k: int(v["bytes"]) for k, v in self._entries().items()}

    def _part_ids(self, name: str) -> list[int]:
        """Manifest-referenced part file ids, in append order."""
        return [int(p) for p in self._entries().get(name, {}).get("parts", ())]

    def parts(self, name: str) -> int:
        """Number of durable parts for ``name`` (0 = not materialized)."""
        return len(self._part_ids(name))

    def _write_manifest(self, entries: dict[str, dict]) -> None:
        tmp = self._manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(entries))
        os.replace(tmp, self._manifest_path)
        self._entries_cache = entries

    def _record(
        self, name: str, nbytes: int, part_id: int, append: bool, dead: int = 0
    ) -> None:
        """Commit point of every mutation: the manifest atomically switches
        the entry to reference the already-durable part file(s). ``dead``
        accumulates the tombstone-debt estimate of appended Z-set parts; a
        full (replacing) write resets it — consolidated content carries no
        retractions."""
        with self._manifest_lock:
            m = dict(self._entries_locked())
            if append and name in m:
                m[name] = {
                    "bytes": int(m[name]["bytes"]) + nbytes,
                    "parts": [*m[name]["parts"], part_id],
                    "dead": int(m[name].get("dead", 0)) + int(dead),
                }
            else:
                m[name] = {"bytes": nbytes, "parts": [part_id]}
            self._write_manifest(m)

    # -- tombstone accounting (consolidation scheduling) -----------------------
    def tombstone_bytes(self, name: str) -> int:
        """Estimated dead bytes of ``name``: appended tombstone rows plus the
        stored rows they retract (reset to 0 by any full rewrite)."""
        return int(self._entries().get(name, {}).get("dead", 0))

    def live_bytes(self, name: str) -> int:
        """Estimated live content bytes of ``name`` (manifest bytes minus the
        tombstone debt; what a consolidation would shrink the entry to)."""
        e = self._entries().get(name, {})
        return max(int(e.get("bytes", 0)) - int(e.get("dead", 0)), 0)

    def tombstone_ratio(self, name: str) -> float:
        """Dead-to-live ratio the consolidation policy thresholds on."""
        return self.tombstone_bytes(name) / max(self.live_bytes(name), 1)

    # -- IO --------------------------------------------------------------------
    def _write_part(self, name: str, part: int, table: Table) -> float:
        """Durable atomic write of one part; throttles on logical bytes."""
        nbytes = table_nbytes(table)
        with obs_trace.span("io.write", name, nbytes):
            t0 = time.perf_counter()
            buf = io.BytesIO()
            np.savez(buf, **{k: v.detach().cpu().numpy()
                             for k, v in table.items()})
            data = buf.getvalue()
            target = self._path(name, part)
            # writer-unique tmp name: under multi-host speculation two
            # workers may durably write the *same* part id concurrently
            # (identical bytes — replayed tasks are deterministic); each
            # needs its own staging file so one rename cannot strand the
            # other's, and whichever os.replace lands last wins harmlessly
            tmp = target.with_suffix(
                f".npz.tmp{os.getpid()}-{threading.get_ident()}"
            )
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, target)
            if self.write_bw:
                residual = nbytes / self.write_bw - (time.perf_counter() - t0)
                if residual > 0:
                    with obs_trace.span("stall.write", name):
                        time.sleep(residual)
                    if obs_trace.enabled():
                        METRICS.inc("stall_seconds.write", residual, entry=name)
            dt = time.perf_counter() - t0
        if obs_trace.enabled():
            METRICS.inc("bytes_written", nbytes, entry=name)
        with self._io_lock:
            self.write_seconds += dt
        return dt

    def write(self, name: str, table: Table) -> float:
        """Persist table as a single new part, replacing any prior content;
        returns elapsed seconds. Atomic even over a multi-part MV: the new
        content lands on a part id the manifest does not reference, the
        manifest commit swaps the entry, and only then are the old (now
        unreferenced) part files removed — a crash at any point leaves the
        manifest-referenced content intact."""
        old_ids = self._part_ids(name)
        new_id = max(old_ids, default=-1) + 1
        dt = self._write_part(name, new_id, table)
        self._record(name, table_nbytes(table), new_id, append=False)
        for p in old_ids:
            self._path(name, p).unlink(missing_ok=True)
        return dt

    def append(self, name: str, delta: Table) -> float:
        """Append one delta part (insert-only refresh). Costs — real and
        throttled — scale with the delta bytes only, the storage-side half of
        the incremental-refresh saving. Returns elapsed seconds."""
        old_ids = self._part_ids(name)
        if not old_ids:
            return self.write(name, delta)
        new_id = max(old_ids) + 1
        dt = self._write_part(name, new_id, delta)
        self._record(
            name, table_nbytes(delta), new_id, append=True,
            dead=_tombstone_bytes_of(delta),
        )
        return dt

    # -- split write/commit (multi-host refresh, DESIGN.md §13) ----------------
    # A multi-host round shares one store root across worker processes, but
    # the manifest keeps a single writer: workers persist part *files* with
    # ``write_part_file`` and report back; only the coordinator process runs
    # ``commit_part``. A worker that dies mid-task leaves at most an orphan
    # (or half-written ``.tmp``) part file the manifest never references, so
    # replaying the task on another host — same coordinator-assigned part id,
    # same deterministic bytes — is safe: the commit happens once, after
    # whichever attempt's durable write reports first.

    def next_part_id(self, name: str) -> int:
        """Smallest part id above every manifest-referenced one — the id
        ``write``/``append`` would pick next. A multi-host coordinator
        assigns it at dispatch so replayed tasks rewrite the *same* part
        file (idempotent recovery)."""
        return max(self._part_ids(name), default=-1) + 1

    def write_part_file(self, name: str, part_id: int, table: Table) -> float:
        """Durably write one part file WITHOUT committing it to the manifest
        (fsync + atomic rename; throttled like any write). The content is
        invisible to readers until ``commit_part`` references it. Returns
        elapsed seconds."""
        return self._write_part(name, int(part_id), table)

    def commit_part(
        self, name: str, part_id: int, nbytes: int, append: bool, dead: int = 0
    ) -> None:
        """Commit an externally written (``write_part_file``) part: append it
        to the entry's part list, or — ``append=False`` — replace the entry
        with this single part and sweep the now-unreferenced old part files.
        Metadata-only on this store object; the caller must guarantee the
        part file is already durable."""
        part_id = int(part_id)
        old_ids = [] if append else [
            p for p in self._part_ids(name) if p != part_id
        ]
        self._record(name, int(nbytes), part_id, append=append, dead=int(dead))
        for p in old_ids:
            self._path(name, p).unlink(missing_ok=True)

    def invalidate_cache(self) -> None:
        """Drop the parsed-manifest cache so the next read reparses the file.

        The single-writer caching assumption (``_entries``) does not hold for
        a multi-host worker: its manifest is committed by the coordinator
        process. Workers invalidate before each task so committed parents
        are visible."""
        with self._manifest_lock:
            self._entries_cache = None

    def consolidate(self, name: str) -> float:
        """Rewrite a multi-part MV as its single consolidated live part,
        dropping tombstones and retracted rows. Atomic at the manifest
        commit (a crash mid-way leaves the old parts authoritative); the
        manifest's byte count shrinks to the live content. Returns elapsed
        seconds (0.0 when already single-part)."""
        if self.parts(name) <= 1:
            return 0.0
        return self.write(name, self.read(name))

    def _load_part(self, name: str, part_id: int) -> dict[str, torch.Tensor]:
        with np.load(self._path(name, part_id)) as z:
            return {k: torch.from_numpy(z[k]).to(self.device) for k in z.files}

    def _throttle_read(self, t0: float, nbytes: int, name: str = "") -> None:
        if self.read_bw:
            residual = nbytes / self.read_bw - (time.perf_counter() - t0)
            if residual > 0:
                with obs_trace.span("stall.read", name):
                    time.sleep(residual)
                if obs_trace.enabled():
                    METRICS.inc("stall_seconds.read", residual, entry=name)

    def read(self, name: str) -> dict[str, torch.Tensor]:
        return self.read_parts(name)

    def read_parts(
        self, name: str, start: int = 0, stop: int | None = None
    ) -> dict[str, torch.Tensor]:
        """Read parts ``[start, stop)`` (default: all) in append order.

        Reading from part 0 consolidates: each later part is applied as a
        Z-set delta (tombstone rids drop the rows they retract, insertions
        splice back in rid order, weight columns are stripped) — the caller
        sees live content. Reading a suffix (``start > 0``) recovers one
        round's raw delta, weights intact, which is how incremental
        execution recovers "this round's update" of a parent. Throttling
        charges the logical bytes of every part actually read — tombstones
        included — not the (smaller) consolidated result."""
        from . import tableops as T

        with obs_trace.span("io.read", name) as sp:
            t0 = time.perf_counter()
            if self.latency:
                time.sleep(self.latency)
            ids = self._part_ids(name)
            loaded = [self._load_part(name, p) for p in ids[start:stop]]
            if not loaded:
                raise KeyError(f"{name}: no parts in [{start}, {stop})")
            raw_bytes = sum(table_nbytes(p) for p in loaded)
            sp.set(nbytes=raw_bytes)
            if start == 0:
                first = loaded[0]
                out = T.materialize_delta(first) if T.WEIGHT_COL in first else first
                for part in loaded[1:]:
                    out = T.apply_delta(out, part)
            elif len(loaded) == 1:
                out = loaded[0]
            else:
                out = T.concat_tables(loaded)
            self._throttle_read(t0, raw_bytes, name)
            dt = time.perf_counter() - t0
        if obs_trace.enabled():
            METRICS.inc("bytes_read", raw_bytes, entry=name)
        with self._io_lock:
            self.read_seconds += dt
        return out

    # -- partitioned MVs -------------------------------------------------------
    # A partitioned MV is a group of independent per-partition part-file
    # entries (``name@p0`` .. ``name@p{P-1}``). Each partition mutates —
    # write / append / consolidate — through the ordinary single-entry
    # methods, so every partition commit is individually atomic at the
    # manifest update and concurrent workers refreshing different partitions
    # of one MV never contend on anything but the manifest lock.

    def write_partition(self, name: str, pid: int, table: Table) -> float:
        return self.write(partition_entry_name(name, pid), table)

    def append_partition(self, name: str, pid: int, delta: Table) -> float:
        return self.append(partition_entry_name(name, pid), delta)

    def read_partition(self, name: str, pid: int) -> dict[str, torch.Tensor]:
        return self.read(partition_entry_name(name, pid))

    def partition_ids(self, name: str) -> list[int]:
        """Sorted partition ids materialized for MV ``name`` (empty when the
        MV is stored unpartitioned or absent)."""
        prefix = name + PARTITION_SEP
        ids = []
        for entry in self._entries():
            if entry.startswith(prefix):
                split = split_partition_name(entry)
                if split is not None and split[0] == name:
                    ids.append(split[1])
        return sorted(ids)

    def partition_manifest(self, name: str) -> dict[int, int]:
        """Per-partition logical bytes of a partitioned MV."""
        m = self.manifest()
        return {
            pid: m[partition_entry_name(name, pid)]
            for pid in self.partition_ids(name)
        }

    def read_partitioned(self, name: str) -> dict[str, torch.Tensor]:
        """Assemble the live content of a partitioned MV in canonical order
        (``partition.concat_partitions``: stable rid order, key order for
        rid-less aggregates) — bitwise-identical to the unpartitioned MV."""
        from .partition import concat_partitions

        ids = self.partition_ids(name)
        if not ids:
            return self.read(name)  # unpartitioned fallback
        return concat_partitions([self.read_partition(name, p) for p in ids])

    def delete(self, name: str) -> None:
        with self._manifest_lock:
            m = dict(self._entries_locked())
            if name in m:
                del m[name]
                self._write_manifest(m)
        # sweep every part file — manifest-referenced, orphaned by a crashed
        # rewrite, or a stale .tmp left mid-write
        for path in (self.root.glob(f"{name}.npz*"),
                     self.root.glob(f"{name}.part*.npz*")):
            for p in path:
                p.unlink(missing_ok=True)

    def reset_counters(self) -> None:
        self.read_seconds = 0.0
        self.write_seconds = 0.0
