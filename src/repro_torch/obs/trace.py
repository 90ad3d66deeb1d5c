"""Thread-safe, low-overhead span recorder for the refresh engine (§12).

One module-level recorder serves the whole process. Spans are recorded by
both execution backends under the *same schema* — the real ``ThreadedEngine``
(wall-clock seconds, ``track="real"``) and ``engine.simulate_events`` (event
clock, ``track="sim"``) — so simulated and real timelines overlay directly
in the Chrome-trace export (``obs.export``). The multi-host coordinator
(``mv.multihost``) adds one track per host (``track="host{h}"``): forked
workers inherit the trace origin ``_t0``, ship their spans back with each
result message, and the coordinator re-records them on the owning host's
track — so one Perfetto export shows every host's timeline side by side on
a common clock.

Span categories (the shared vocabulary; dotted suffixes refine a family):

========================  ==================================================
``task``                  one node execution end to end (gather+compute+put)
``read.catalog``          a parent gathered from the Memory Catalog (a hit)
``read.disk``             a parent gathered from storage (a miss)
``read.base``             a base-table scan (simulator; never cached)
``compute``               the node's pure compute
``write.sync``            blocking materialization on the worker's channel
``write.behind``          background materialization (the Fig. 6 drain)
``io.read`` ``io.write``  DiskStore part-file I/O (nested in the above)
``stall.read/.write``     DiskStore bandwidth-throttle sleep inside an io op
``admit`` ``release``     Memory Catalog entry lifecycle (instant events)
``catalog.bytes``         catalog occupancy counter samples
``round``                 one engine run / one simulated round (the frame
                          every other span of that run nests inside)
``redispatch``            a task moved off a lost/straggling host by the
                          multi-host coordinator (instant, on the receiving
                          host's track)
========================  ==================================================

Every span is keyed by ``(mv, partition, round, worker)``: ``mv``/
``partition`` are derived from the store entry name (``mv3@p2`` →
``("mv3", 2)``; unpartitioned → partition ``-1``), ``round`` comes from the
process-wide context (set by the scenario drivers via ``set_round``), and
``worker`` is the recording thread (real) or the virtual channel (sim).

Overhead contract: recording is a flag check plus one lock-guarded list
append. When tracing is disabled (``SC_TRACE`` unset/0 and no programmatic
``enable()``), ``span()`` returns a shared singleton null context and
``record``/``instant``/``counter`` return immediately — the disabled fast
path allocates nothing, so instrumented hot paths cost one predicate per
call site (verified in ``tests/obs/test_obs.py``). Tracing is *passive*: it
never influences scheduling, data, or stored bytes, so traced and untraced
runs are bitwise identical.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Iterable, NamedTuple

__all__ = [
    "Span",
    "enabled",
    "enable",
    "set_round",
    "current_round",
    "clear",
    "drain",
    "spans",
    "now",
    "span",
    "record",
    "instant",
    "counter",
    "split_entry",
    "sim_offset",
    "set_sim_offset",
]


class Span(NamedTuple):
    """One recorded event. ``ts``/``dur`` are seconds on the recording
    backend's clock: wall seconds since process trace origin for
    ``track="real"``, simulated event-clock seconds for ``track="sim"``.
    Counter samples carry the sampled value in ``value`` with ``dur=0``."""

    cat: str
    name: str
    ts: float
    dur: float
    mv: str
    partition: int
    round: int
    worker: str
    track: str
    nbytes: float = 0.0
    value: float = 0.0


_lock = threading.Lock()
_spans: list[Span] = []
_round = -1
# trace origin for the real clock: spans are recorded relative to this so
# exported timelines start near zero even in long processes
_t0 = time.perf_counter()

_enabled = os.environ.get("SC_TRACE", "").strip() not in ("", "0", "false")


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Programmatic override of ``SC_TRACE`` (tests, the sc_trace CLI)."""
    global _enabled
    _enabled = bool(on)


def set_round(round_idx: int) -> None:
    """Set the process-wide round context stamped on subsequent spans.

    Scenario drivers run rounds strictly serially, so one mutable value is
    race-free in practice; worker threads only read it."""
    global _round
    _round = int(round_idx)


def current_round() -> int:
    return _round


# cumulative event-clock offset for the sim track: each simulated round
# advances it by its own makespan so multi-round sim traces lay out
# sequentially (like real wall-clock rounds do naturally)
_sim_offset = 0.0


def sim_offset() -> float:
    return _sim_offset


def set_sim_offset(value: float) -> None:
    global _sim_offset
    _sim_offset = float(value)


def clear() -> None:
    global _spans, _sim_offset
    with _lock:
        _spans = []
    _sim_offset = 0.0


def drain() -> list[Span]:
    """Return all recorded spans and clear the buffer (sim clock rewinds)."""
    global _spans, _sim_offset
    with _lock:
        out, _spans = _spans, []
    _sim_offset = 0.0
    return out


def spans() -> list[Span]:
    """Snapshot of the recorded spans (buffer retained)."""
    with _lock:
        return list(_spans)


def now() -> float:
    """Seconds on the real track's clock (relative to the trace origin)."""
    return time.perf_counter() - _t0


def split_entry(name: str) -> tuple[str, int]:
    """Store entry name -> ``(mv, partition)``; partition -1 when the name
    is unpartitioned. Mirrors ``storage.split_partition_name`` without the
    import cycle."""
    base, sep, pid = name.rpartition("@p")
    if sep and pid.isdigit():
        return base, int(pid)
    return name, -1


def record(
    cat: str,
    name: str,
    ts: float,
    dur: float,
    nbytes: float = 0.0,
    worker: str | None = None,
    track: str = "real",
    value: float = 0.0,
    round_idx: int | None = None,
) -> None:
    """Append one span with explicit timestamps (the simulator's entry
    point; real-clock callers prefer the ``span()`` context manager)."""
    if not _enabled:
        return
    mv, part = split_entry(name)
    s = Span(
        cat=cat,
        name=name,
        ts=ts,
        dur=dur,
        mv=mv,
        partition=part,
        round=_round if round_idx is None else round_idx,
        worker=worker if worker is not None else threading.current_thread().name,
        track=track,
        nbytes=nbytes,
        value=value,
    )
    with _lock:
        _spans.append(s)


def instant(cat: str, name: str, nbytes: float = 0.0) -> None:
    """Zero-duration real-clock event (catalog admit/release)."""
    if not _enabled:
        return
    record(cat, name, now(), 0.0, nbytes=nbytes)


def counter(name: str, value: float) -> None:
    """Real-clock counter sample (catalog occupancy timeline)."""
    if not _enabled:
        return
    record("counter", name, now(), 0.0, value=float(value))


class _NullSpan:
    """Singleton no-op context for the disabled fast path: ``span()``
    returns this very object, so tracing-off call sites allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, nbytes: float = 0.0) -> None:
        pass


_NULL = _NullSpan()


class _SpanCtx:
    __slots__ = ("cat", "name", "nbytes", "_start")

    def __init__(self, cat: str, name: str, nbytes: float):
        self.cat = cat
        self.name = name
        self.nbytes = nbytes

    def set(self, nbytes: float = 0.0) -> None:
        """Attach the byte count once known (e.g. after a multi-part read)."""
        self.nbytes = nbytes

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        record(self.cat, self.name, self._start - _t0, end - self._start,
               nbytes=self.nbytes)
        return False


def span(cat: str, name: str, nbytes: float = 0.0):
    """Real-clock span context manager. Disabled → the shared null context
    (no allocation); enabled → records on ``__exit__``."""
    if not _enabled:
        return _NULL
    return _SpanCtx(cat, name, nbytes)


def filter_spans(
    items: Iterable[Span],
    cat: str | None = None,
    track: str | None = None,
    round_idx: int | None = None,
    mv: str | None = None,
) -> list[Span]:
    """Convenience filter used by the audit/export layers and tests."""
    out = []
    for s in items:
        if cat is not None and not s.cat.startswith(cat):
            continue
        if track is not None and s.track != track:
            continue
        if round_idx is not None and s.round != round_idx:
            continue
        if mv is not None and s.mv != mv:
            continue
        out.append(s)
    return out
