"""Fault tolerance: preemption-safe shutdown and straggler detection; the
counterpart of ``repro.runtime.ft`` (``elastic_restore`` comes with the
sharding slice of the port).

Designed for 1000+-node operation: every mechanism is per-host-local with
O(1) state, no global coordination beyond what the checkpoint already
provides.

* ``PreemptionHandler`` — converts SIGTERM/SIGINT into a cooperative flag the
  training loop polls; the loop checkpoints (write-behind flushed) and exits 0
  so the scheduler restarts cleanly from LATEST.
* ``StragglerDetector`` — per-host step-duration EWMA vs the fleet median;
  hosts slower than ``threshold ×`` median for ``patience`` consecutive steps
  are flagged (the caller re-dispatches or evicts; here surfaced as events).
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import threading
from typing import Any


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev: dict[int, Any] = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    duration: float
    median: float


class StragglerDetector:
    """Flags hosts whose step time exceeds ``threshold`` × fleet median for
    ``patience`` consecutive steps."""

    def __init__(self, n_hosts: int, threshold: float = 2.0, patience: int = 3,
                 ewma: float = 0.5):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.patience = patience
        self.ewma = ewma
        self._avg = [0.0] * n_hosts
        self._strikes = [0] * n_hosts
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, durations: list[float]) -> list[int]:
        """Feed per-host step durations; returns hosts flagged this step."""
        if len(durations) != self.n_hosts:
            raise ValueError(f"{len(durations)} durations for {self.n_hosts} hosts")
        for h, d in enumerate(durations):
            self._avg[h] = (
                d if self._avg[h] == 0.0
                else self.ewma * d + (1 - self.ewma) * self._avg[h]
            )
        med = statistics.median(self._avg)
        flagged = []
        for h in range(self.n_hosts):
            if med > 0 and self._avg[h] > self.threshold * med:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                flagged.append(h)
                self.events.append(
                    StragglerEvent(step, h, self._avg[h], med)
                )
                self._strikes[h] = 0  # re-arm after reporting
        return flagged
