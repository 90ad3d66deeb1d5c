"""Counter/gauge/histogram registry for the refresh engine (§12).

A minimal, thread-safe metrics surface the engine, store, and catalog record
into when observability is on (the same ``SC_TRACE`` / ``obs.trace.enable``
switch gates both spans and metrics, so the disabled hot path pays one
predicate). Metrics are cumulative across rounds until ``clear()``; the
scenario drivers snapshot per-round walls as histogram observations.

Naming: a metric has a ``name`` and an optional ``entry`` label (the store
entry / MV name), so per-entry families — catalog hit/miss/overflow, bytes
read/written, throttle stalls — aggregate naturally: the exported snapshot
nests ``{name: {entry: value}}`` with the unlabeled series under ``""``.

Standard series recorded by the instrumented stack:

=============================  =============================================
``bytes_read`` / ``bytes_written``  DiskStore logical I/O per entry
``stall_seconds.read/.write``  bandwidth-throttle sleep per entry
``catalog_hits/misses/overflow``    engine gather/admission outcomes per entry
``catalog_used_bytes``         gauge: occupancy after the last admit/release
``join_fallbacks``             JOIN partial-fallback rounds (incremental)
``round_wall_s``               histogram: per-round engine wall seconds
=============================  =============================================
"""
from __future__ import annotations

import json
import math
import threading
from pathlib import Path
from typing import Any

__all__ = ["MetricsRegistry", "METRICS"]


class _Hist:
    """Power-of-two bucketed histogram: count/sum/min/max plus bucket
    counts keyed by ``ceil(log2(v))`` (bucket ``None`` holds v <= 0)."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: dict[int | None, int] = {}

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        b = None if v <= 0.0 else int(math.ceil(math.log2(v)))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def to_dict(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "mean": (self.total / self.count) if self.count else None,
            "log2_buckets": {
                ("<=0" if k is None else str(k)): v
                for k, v in sorted(
                    self.buckets.items(), key=lambda kv: (kv[0] is None, kv[0] or 0)
                )
            },
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, dict[str, float]] = {}
        self._gauges: dict[str, dict[str, float]] = {}
        self._hists: dict[str, dict[str, _Hist]] = {}

    # -- recording -----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, entry: str = "") -> None:
        with self._lock:
            fam = self._counters.setdefault(name, {})
            fam[entry] = fam.get(entry, 0.0) + value

    def gauge(self, name: str, value: float, entry: str = "") -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[entry] = float(value)

    def observe(self, name: str, value: float, entry: str = "") -> None:
        with self._lock:
            fam = self._hists.setdefault(name, {})
            h = fam.get(entry)
            if h is None:
                h = fam[entry] = _Hist()
            h.observe(float(value))

    # -- reading -------------------------------------------------------------
    def counter_value(self, name: str, entry: str = "") -> float:
        with self._lock:
            return self._counters.get(name, {}).get(entry, 0.0)

    def counter_family(self, name: str) -> dict[str, float]:
        with self._lock:
            return dict(self._counters.get(name, {}))

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "counters": {k: dict(v) for k, v in self._counters.items()},
                "gauges": {k: dict(v) for k, v in self._gauges.items()},
                "histograms": {
                    k: {e: h.to_dict() for e, h in v.items()}
                    for k, v in self._hists.items()
                },
            }

    def export_json(self, path: str | Path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.snapshot(), indent=1, sort_keys=True))
        return p

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: Process-wide registry the instrumented stack records into.
METRICS = MetricsRegistry()
