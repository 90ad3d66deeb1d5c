"""Memory Catalog (paper §III-C): bounded in-memory store for flagged nodes.

Semantics follow the paper exactly: a flagged node's output is *created in*
the catalog, stays resident while any of its children is yet to execute, and
is released as soon as the last child has completed. Accounting is byte-exact
against the configured budget; exceeding it raises (the optimizer guarantees
feasible plans, so a raise here is a scheduling bug, not an eviction policy).

Thread-safe: the Controller's main loop and the background materializer touch
the catalog concurrently.
"""
from __future__ import annotations

import threading
from typing import Any

from ..obs import trace as obs_trace
from ..obs.metrics import METRICS


class CatalogOverflowError(RuntimeError):
    pass


class MemoryCatalog:
    def __init__(self, budget_bytes: float):
        self.budget = float(budget_bytes)
        self._entries: dict[str, tuple[Any, float]] = {}
        self._used = 0.0
        self._peak = 0.0
        self._lock = threading.Lock()

    # -- capacity -----------------------------------------------------------
    @property
    def used_bytes(self) -> float:
        return self._used

    @property
    def peak_bytes(self) -> float:
        return self._peak

    def fits(self, size: float) -> bool:
        with self._lock:
            return self._used + size <= self.budget + 1e-9

    # -- operations ----------------------------------------------------------
    def put(self, name: str, value: Any, size: float) -> None:
        with self._lock:
            if name in self._entries:
                raise KeyError(f"{name} already in catalog")
            if self._used + size > self.budget + 1e-9:
                raise CatalogOverflowError(
                    f"putting {name} ({size:.0f}B) exceeds budget "
                    f"({self._used:.0f}/{self.budget:.0f}B used)"
                )
            self._entries[name] = (value, size)
            self._used += size
            self._peak = max(self._peak, self._used)
            if obs_trace.enabled():
                self._trace_admit(name, size)

    def try_put(self, name: str, value: Any, size: float) -> bool:
        """Atomically admit ``name`` iff it fits; False instead of raising.

        The parallel engine's workers race on admission, so the check and the
        insert must be one critical section (``fits()`` + ``put()`` is not).
        """
        with self._lock:
            if name in self._entries or self._used + size > self.budget + 1e-9:
                return False
            self._entries[name] = (value, size)
            self._used += size
            self._peak = max(self._peak, self._used)
            if obs_trace.enabled():
                self._trace_admit(name, size)
            return True

    def get(self, name: str) -> Any:
        with self._lock:
            return self._entries[name][0]

    def entry_bytes(self, name: str) -> float:
        """Accounted bytes of a resident entry (0.0 when absent)."""
        with self._lock:
            e = self._entries.get(name)
            return e[1] if e is not None else 0.0

    def resident(self) -> dict[str, float]:
        """Snapshot of resident entry names -> accounted bytes."""
        with self._lock:
            return {k: s for k, (_, s) in self._entries.items()}

    def used_bytes_for(self, name: str) -> float:
        """Bytes resident for MV ``name``: its own entry plus any
        partition-granular entries (``name@p0``, ``name@p1`` ... admitted
        and released independently). Matches whole name components only —
        ``mv1`` never counts ``mv10``'s partitions."""
        from .storage import PARTITION_SEP

        prefix = name + PARTITION_SEP
        with self._lock:
            return sum(
                s
                for k, (_, s) in self._entries.items()
                if k == name or k.startswith(prefix)
            )

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def release(self, name: str) -> None:
        with self._lock:
            if name in self._entries:
                _, size = self._entries.pop(name)
                self._used -= size
                if obs_trace.enabled():
                    obs_trace.instant("release", name, size)
                    obs_trace.counter("catalog.bytes", self._used)
                    METRICS.gauge("catalog_used_bytes", self._used)

    # emitted inside put/try_put's critical section; safe because the trace
    # and metrics locks never call back into the catalog
    def _trace_admit(self, name: str, size: float) -> None:
        obs_trace.instant("admit", name, size)
        obs_trace.counter("catalog.bytes", self._used)
        METRICS.gauge("catalog_used_bytes", self._used)

    def clear(self) -> None:
        """Drop every entry and reset statistics. A reused catalog (the
        engine's restart path, crash/resume, multi-round refresh) must not
        report the previous run's peak."""
        with self._lock:
            self._entries.clear()
            self._used = 0.0
            self._peak = 0.0

    def reset_stats(self) -> None:
        """Reset statistics (peak) without dropping resident entries."""
        with self._lock:
            self._peak = self._used
