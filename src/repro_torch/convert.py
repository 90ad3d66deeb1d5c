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
from .models.transformer import Block, Transformer, check_supported, layer_kinds


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


def _ffn_names(cfg: ModelConfig, mlp: str) -> tuple[str, ...]:
    """The feed-forward's tensors under their dotted names: a dense MLP's
    ``wi, wo``; an MoE's ``router, w_in, w_out`` and its shared and dense
    MLPs' where the config has them."""
    if mlp != "moe":
        return ("wi", "wo")
    return (("router", "w_in", "w_out")
            + (("shared.wi", "shared.wo") if cfg.moe_shared_experts else ())
            + (("dense.wi", "dense.wo") if cfg.moe_dense_residual else ()))


def named_reference_arrays(cfg: ModelConfig, tree: Mapping) -> dict[str, np.ndarray]:
    """A JAX parameter tree of numpy arrays (``embed``, ``blocks.subI.{norm1,
    mixer.{...}, norm2, ffn.{...}}`` stacked on a leading group axis, with
    an attention mixer's ``wq, wk, wv, wo`` or a Mamba-2 mixer's 13 tensors
    (``layers.SSM_NAMES``), a dense MLP's ``ffn.{wi,wo}`` or an MoE's
    ``ffn.{router,w_in,w_out}`` with ``ffn.shared.{wi,wo}`` and
    ``ffn.dense.{wi,wo}`` where it has them, and no ``norm2``/``ffn`` on a
    layer without one; ``final_norm``, ``lm_head`` unless embeddings are
    tied, ``patch_adapter`` for the ``vlm`` frontend) keyed by the port's
    parameter names (``Transformer.named_parameters()``): group g's
    sub-layer i is layer ``g * len(cfg.pattern) + i``. The same mapping
    carries the AdamW moments, which share the tree's structure."""
    check_supported(cfg)
    out = {"embed": np.asarray(tree["embed"])}
    for n, (mixer, mlp) in enumerate(layer_kinds(cfg)):
        g, i = divmod(n, len(cfg.pattern))
        sub = tree["blocks"][f"sub{i}"]
        out[f"layers.{n}.norm1"] = np.asarray(sub["norm1"][g])
        for k in (("wq", "wk", "wv", "wo") if mixer == "attn" else L.SSM_NAMES):
            out[f"layers.{n}.mixer.{k}"] = np.asarray(sub["mixer"][k][g])
        if mlp is not None:
            out[f"layers.{n}.norm2"] = np.asarray(sub["norm2"][g])
            for k in _ffn_names(cfg, mlp):
                node = sub["ffn"]
                for part in k.split("."):
                    node = node[part]
                out[f"layers.{n}.ffn.{k}"] = np.asarray(node[g])
    out["final_norm"] = np.asarray(tree["final_norm"])
    if not cfg.tie_embeddings:
        out["lm_head"] = np.asarray(tree["lm_head"])
    if cfg.frontend == "vlm":
        out["patch_adapter"] = np.asarray(tree["patch_adapter"])
    return out


def _ffn(cfg: ModelConfig, mlp: str, w: dict, pre: str) -> L.MLP | L.MoE:
    if mlp != "moe":
        return L.MLP(w[f"{pre}ffn.wi"], w[f"{pre}ffn.wo"])
    mlps = {part: L.MLP(w[f"{pre}ffn.{part}.wi"], w[f"{pre}ffn.{part}.wo"])
            for part in ("shared", "dense") if f"{pre}ffn.{part}.wi" in w}
    return L.MoE(w[f"{pre}ffn.router"], w[f"{pre}ffn.w_in"], w[f"{pre}ffn.w_out"], **mlps)


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device: str | torch.device | None = None) -> Transformer:
    """The port's model on ``device`` (default: the card) with the weights
    of a JAX parameter tree of numpy arrays (``jax.tree.map(np.asarray,
    repro.models.init_params(cfg, key))``; see :func:`named_reference_arrays`).
    Every weight keeps its ``x @ w`` orientation and its bits."""
    dev = resolve_device(device)
    w = {k: _weight(a, dev) for k, a in named_reference_arrays(cfg, tree).items()}
    layers = []
    for n, (mixer, mlp) in enumerate(layer_kinds(cfg)):
        pre = f"layers.{n}."
        mix = (L.Attention(*(w[f"{pre}mixer.{k}"] for k in ("wq", "wk", "wv", "wo")))
               if mixer == "attn" else
               L.SSM(**{k: w[f"{pre}mixer.{k}"] for k in L.SSM_NAMES}))
        ffn = () if mlp is None else (w[f"{pre}norm2"], _ffn(cfg, mlp, w, pre))
        layers.append(Block(w[f"{pre}norm1"], mix, *ffn))
    return Transformer(cfg, w["embed"], layers, w["final_norm"], w.get("lm_head"),
                       w.get("patch_adapter"))


def train_state_from_reference(cfg: ModelConfig, state_tree: Mapping,
                               device: str | torch.device | None = None) -> dict:
    """The port's train state (``train.init_train_state``'s structure) on
    ``device`` (default: the card) from a JAX train state of numpy arrays
    (``jax.tree.map(np.asarray, state)`` of ``{"params", "opt": {"m", "v",
    "step"}}`` and, from ``init_train_state(compress_grads=True)``,
    ``"ef_error"``): the model made trainable, and the moments, the int32
    step count and the compression errors, every value bit for bit."""
    dev = resolve_device(device)
    model = params_from_reference(cfg, state_tree["params"], dev).requires_grad_(True)
    opt = state_tree["opt"]

    def named(tree):
        return {k: _weight(a, dev) for k, a in named_reference_arrays(cfg, tree).items()}

    state = {
        "params": model,
        "opt": {
            "m": named(opt["m"]),
            "v": named(opt["v"]),
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=dev),
        },
    }
    if "ef_error" in state_tree:
        state["ef_error"] = named(state_tree["ef_error"])
    return state
