"""Moving data between the port and numpy (and the JAX package's plans).

In this system data takes the place of a model's weights: tables and plans
are what the two packages exchange. Tables cross as numpy arrays, bit for
bit; a plan crosses field by field. Nothing here imports the JAX package —
``plan_from_reference`` reads a reference ``Plan`` by its field names.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .core.altopt import Plan
from .device import resolve_device


def table_from_numpy(table: Mapping[str, np.ndarray],
                     device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor]:
    """A table of numpy arrays as tensors on ``device`` (default: the card),
    bit for bit; the result shares no memory with the input."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in table.items()}


def table_to_numpy(table: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A table of tensors as numpy arrays on the host, bit for bit; the
    result shares no memory with the input."""
    out = {}
    for k, v in table.items():
        a = v.detach().cpu().numpy()
        out[k] = a.copy() if v.device.type == "cpu" else a
    return out


def plan_from_reference(plan) -> Plan:
    """The port's ``Plan`` with every field copied from a reference plan."""
    return Plan(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(Plan)})
