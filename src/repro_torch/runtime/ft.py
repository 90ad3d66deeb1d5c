"""Fault tolerance: preemption-safe shutdown, straggler detection, elastic
restart; the counterpart of ``repro.runtime.ft``.

Designed for 1000+-node operation: every mechanism is per-host-local with
O(1) state, no global coordination beyond what the checkpoint already
provides.

* ``PreemptionHandler`` — converts SIGTERM/SIGINT into a cooperative flag the
  training loop polls; the loop checkpoints (write-behind flushed) and exits 0
  so the scheduler restarts cleanly from LATEST.
* ``StragglerDetector`` — per-host step-duration EWMA vs the fleet median;
  hosts slower than ``threshold ×`` median for ``patience`` consecutive steps
  are flagged (the caller re-dispatches or evicts; here surfaced as events).
* ``elastic_restore`` — checkpoints are topology-agnostic arrays keyed by
  leaf path; restoring on other devices is a copy to each leaf's new place,
  on a mesh each rank's shard of it.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


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


def _leaf_key(path) -> str:
    """A leaf's checkpoint key: its path "/"-joined, each entry by its
    mapping key or sequence index (the reference's keys)."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _as_tensor(value: Any) -> torch.Tensor:
    """A checkpoint value as a tensor; a numpy bf16 array (the reference's
    ``ml_dtypes`` type, which torch cannot read) through its 16-bit view."""
    if isinstance(value, np.ndarray) and value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(value)


def elastic_restore(flat: dict, template: Any, shardings: Any = None) -> Any:
    """Rebuild a state pytree from a topology-agnostic checkpoint dict on the
    *current* devices (which may differ from those that saved it).

    ``flat`` maps each leaf's "/"-joined path to its array (numpy or
    tensor), as either package's ``CheckpointManager.restore_flat`` returns
    it. Each leaf takes its template leaf's dtype. ``shardings=None`` puts
    it on its template leaf's device; otherwise a pytree with the
    template's structure gives each leaf's place: a ``torch.device``, or a
    sharding on a mesh (anything with ``.mesh`` and ``.spec``, as the
    reference takes any leaf with a ``spec``: ``sharding.layout.
    NamedSharding``), for which the whole array is cut to this rank's shard
    (``sharding.layout.shard_tensor``, the fused gate|up dimension by its
    ``fused_last``) on its template leaf's device; the shard must have the
    template leaf's shape."""
    paths, spec = pytree.tree_flatten_with_path(template)
    if shardings is None:
        places = [None] * len(paths)
    else:
        placed = dict((_leaf_key(path), place) for path, place in
                      pytree.tree_flatten_with_path(shardings)[0])
        if len(placed) != len(paths) or any(_leaf_key(p) not in placed for p, _ in paths):
            raise ValueError(
                f"{len(placed)} placements for {len(paths)} template leaves")
        places = [placed[_leaf_key(path)] for path, _ in paths]
        bad = [p for p in places if not (isinstance(p, torch.device) or hasattr(p, "spec"))]
        if bad:
            raise TypeError(f"placement {bad[0]!r}: elastic_restore places a leaf on a "
                            "torch.device or a sharding with .mesh and .spec")
    out = []
    for (path, leaf), place in zip(paths, places):
        like = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        arr = _as_tensor(flat[_leaf_key(path)])
        if hasattr(place, "spec"):
            from ..sharding.layout import shard_tensor

            arr = shard_tensor(arr, place.spec, place.mesh,
                               fused_last=getattr(place, "fused_last", False))
            if arr.shape != like.shape:
                raise ValueError(f"{_leaf_key(path)}: a shard of shape {tuple(arr.shape)} "
                                 f"for a template leaf of {tuple(like.shape)}")
            place = None
        out.append(arr.to(device=like.device if place is None else place, dtype=like.dtype,
                          copy=True))
    return pytree.tree_unflatten(out, spec)
