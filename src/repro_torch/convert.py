"""Moving data between the port and numpy (and the JAX package's plans and
model weights).

In the MV system data takes the place of a model's weights: tables and
plans are what the two packages exchange. Tables cross as numpy arrays, bit
for bit; a plan crosses field by field; the model stack's weights cross as
the JAX parameter tree of numpy arrays. Nothing here imports the JAX package
(or ``ml_dtypes``) — ``plan_from_reference`` reads a reference ``Plan`` by
its field names.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.altopt import Plan
from .device import resolve_device
from .models import layers as L
from .models.transformer import Block, Transformer, check_supported


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


def _weight(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``, bit for bit. JAX's bf16 arrays
    come as ``ml_dtypes.bfloat16``, which torch cannot read: they cross as
    their uint16 bits."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device: str | torch.device | None = None) -> Transformer:
    """The port's model on ``device`` (default: the card) with the weights
    of a JAX parameter tree of numpy arrays (``jax.tree.map(np.asarray,
    repro.models.init_params(cfg, key))``): ``embed``, ``blocks.subI.{norm1,
    mixer.{wq,wk,wv,wo}, norm2, ffn.{wi,wo}}`` stacked on a leading group
    axis, ``final_norm`` and ``lm_head`` unless embeddings are tied. Group g's
    sub-layer i becomes layer ``g * len(cfg.pattern) + i``; every weight
    keeps its ``x @ w`` orientation."""
    dev = resolve_device(device)
    check_supported(cfg)
    w = lambda a: _weight(np.asarray(a), dev)  # noqa: E731
    layers = []
    for g in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            sub = tree["blocks"][f"sub{i}"]
            mix, ffn = sub["mixer"], sub["ffn"]
            layers.append(Block(
                w(sub["norm1"][g]),
                L.Attention(*(w(mix[k][g]) for k in ("wq", "wk", "wv", "wo"))),
                w(sub["norm2"][g]),
                L.MLP(w(ffn["wi"][g]), w(ffn["wo"][g]))))
    lm_head = None if cfg.tie_embeddings else w(tree["lm_head"])
    return Transformer(cfg, w(tree["embed"]), layers, w(tree["final_norm"]), lm_head)
