"""Per-architecture sharding rules: the counterpart of
``repro.sharding.strategy``.

Mesh axes: ``('data', 'model')`` on one pod (16 × 16), ``('pod', 'data',
'model')`` on two (2 × 16 × 16). The data-parallel "DP" entry of a spec is
the tuple of every axis but ``model``, so batch, ZeRO and FSDP sharding use
pod × data.

The strategy is the reference's (its module docstring and DESIGN.md §6):
tensor parallelism over ``model`` (q heads, the MLP's hidden width, the
vocabulary, MoE experts when ``E_pad % tp == 0`` and else each expert's
hidden width, the SSD heads); k/v replicated when ``n_kv_heads % tp != 0``;
FSDP over DP on a weight's free dimension with ``cfg.fsdp_params``; ZeRO-1
moments always on the FSDP-style spec.

Specs are keyed by the port's parameter names
(``Transformer.named_parameters()``: ``embed``, ``layers.{n}.mixer.wq``,
…). A layer's tensor takes the reference's spec of its stacked leaf
(``blocks/sub{n % len(pattern)}/…``) without the leading group entry. A
cache spec is a list with one dict a layer, as ``models.make_cache``
returns. Every function reads only shapes (a mapping of names to tensors,
to shapes or to anything with ``.shape``; a module's parameters; a
meta-device cache) and a mesh (anything with ``axis_names`` and
``devices.shape``): no weight is allocated.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

from torch import nn

from ..configs.base import ModelConfig


class PartitionSpec(tuple):
    """One tensor's layout over a mesh, as ``jax.sharding.PartitionSpec``: a
    tuple with an entry a dimension, each ``None`` (whole), an axis name, or
    a tuple of axis names (the dimension split over their product, the
    first axis major). A tuple of one axis is kept as the axis's name, as
    jax keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes, as a tuple (``()`` for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _tp(mesh) -> int:
    return mesh_axis_sizes(mesh)["model"]


def kv_shardable(cfg: ModelConfig, mesh) -> bool:
    """Whether k/v (and the kv cache) split their heads over ``model``."""
    return cfg.n_kv_heads > 0 and cfg.n_kv_heads % _tp(mesh) == 0


def expert_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether an MoE splits its experts over ``model`` (else each
    expert's hidden width)."""
    return cfg.moe_experts > 0 and cfg.moe_experts_padded % _tp(mesh) == 0


def _stacked_path(name: str, cfg: ModelConfig) -> tuple[str, ...]:
    """A port name's path in the reference's tree (``layers.{n}.rest`` →
    ``blocks/sub{n % len(pattern)}/rest``)."""
    head, _, rest = name.partition(".")
    if head != "layers":
        return (name,)
    n, _, rest = rest.partition(".")
    return ("blocks", f"sub{int(n) % len(cfg.pattern)}", *rest.split("."))


def _param_rule(cfg: ModelConfig, mesh, fsdp: bool):
    """The reference's rule (``strategy.py:54``) on a stacked leaf's path
    and rank."""
    tp = _tp(mesh)
    dfree = dp_axes(mesh) if fsdp else None
    kv_ok = kv_shardable(cfg, mesh)
    ep = expert_parallel(cfg, mesh)
    ssm_h_ok = cfg.ssm_heads % tp == 0 if cfg.ssm_state else False

    def rule(path: tuple[str, ...], nd: int) -> P:
        name = path[-1]
        joined = "/".join(path)
        if name == "embed":
            return P("model", dfree)
        if name in ("lm_head", "patch_adapter"):
            return P(dfree, "model")
        if name == "final_norm" or "norm" in name:
            return P(*([None] * nd))
        if name == "wq":
            return P(None, dfree, "model")
        if name in ("wk", "wv"):
            return P(None, dfree, "model" if kv_ok else None)
        if name == "wo" and "mixer" in joined:
            return P(None, "model", dfree)
        if name == "wi":  # dense / shared MLP, fused gate|up
            return P(None, dfree, "model")
        if name == "wo":  # ffn down-projection
            return P(None, "model", dfree)
        if name == "router":
            return P(None, None, None)
        if name == "w_in":  # (G, E, d, 2ffe)
            return P(None, "model", dfree, None) if ep else P(None, None, dfree, "model")
        if name == "w_out":  # (G, E, ffe, d)
            return P(None, "model", None, dfree) if ep else P(None, None, "model", dfree)
        if name in ("w_z", "w_x"):
            return P(None, dfree, "model")
        if name in ("w_bc", "w_dt"):
            return P(None, dfree, None)
        if name == "conv_x_w":
            return P(None, None, "model")
        if name in ("conv_x_b", "norm_w"):
            return P(None, "model")
        if name == "conv_bc_w":
            return P(None, None, None)
        if name == "conv_bc_b":
            return P(None, None)
        if name in ("a_log", "d_skip", "dt_bias"):
            return P(None, "model") if ssm_h_ok else P(None, None)
        if name == "out_proj":
            return P(None, "model", dfree)
        return P(*([None] * nd))

    return rule


def shapes_of(tree: Any) -> dict[str, tuple[int, ...]]:
    """Name → shape of a module's parameters or of a mapping whose values
    are tensors, shapes, or anything with ``.shape``."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if not isinstance(tree, Mapping):
        raise TypeError(f"expected a module or a mapping of names, got {type(tree)}")
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v) for k, v in tree.items()}


def param_spec(cfg: ModelConfig, name: str, ndim: int, mesh, fsdp: bool | None = None) -> P:
    """One parameter's spec by its port name and rank (see
    :func:`param_specs`)."""
    if fsdp is None:
        fsdp = cfg.fsdp_params
    path = _stacked_path(name, cfg)
    if path[0] == "blocks":
        return P(*_param_rule(cfg, mesh, fsdp)(path, ndim + 1)[1:])
    return _param_rule(cfg, mesh, fsdp)(path, ndim)


def param_specs(cfg: ModelConfig, params_shape: Any, mesh,
                fsdp: bool | None = None) -> dict[str, P]:
    """Name → PartitionSpec of every parameter (``strategy.py:44``)."""
    return {k: param_spec(cfg, k, len(s), mesh, fsdp)
            for k, s in shapes_of(params_shape).items()}


def opt_state_specs(cfg: ModelConfig, params_shape: Any, mesh) -> dict[str, P]:
    """ZeRO-1: the moments take the FSDP-style spec unconditionally."""
    return param_specs(cfg, params_shape, mesh, fsdp=True)


def batch_specs(cfg: ModelConfig, mesh) -> dict[str, P]:
    DP = dp_axes(mesh)
    spec = {"tokens": P(DP, None), "labels": P(DP, None)}
    if cfg.frontend == "vlm":
        spec["patch_embeds"] = P(DP, None, None)
    return spec


def cache_specs(cfg: ModelConfig, cache_shape: Any, mesh) -> list[dict[str, P]]:
    """The decode cache's specs, a dict a layer (``strategy.py:122``):
    batch over DP; kv heads over ``model`` when divisible, else the
    sequence with ``cfg.shard_cache_seq``; SSD heads and the conv's
    d_inner over ``model``."""
    tp = _tp(mesh)
    DP = dp_axes(mesh)
    kv_ok = kv_shardable(cfg, mesh)
    ssm_h_ok = cfg.ssm_heads % tp == 0 if cfg.ssm_state else False

    def rule(name: str, nd: int) -> P:
        if name in ("k", "v"):    # (b, kv, S, hd)
            if kv_ok:
                return P(DP, "model", None, None)
            if cfg.shard_cache_seq:
                return P(DP, None, "model", None)
            return P(DP, None, None, None)
        if name == "conv_x":      # (b, k-1, di)
            return P(DP, None, "model")
        if name == "conv_bc":
            return P(DP, None, None)
        if name == "ssm":         # (b, h, hd, n)
            return P(DP, "model" if ssm_h_ok else None, None, None)
        return P(*([None] * nd))

    return [{k: rule(k, len(v.shape)) for k, v in entry.items()} for entry in cache_shape]


def activation_sharding_constraint(mesh) -> P:
    """(b, s, d) activations: batch over DP."""
    return P(dp_axes(mesh), None, None)


def audit_divisibility(cfg: ModelConfig, params_shape: Any, mesh,
                       specs: Mapping[str, P] | None = None) -> list[str]:
    """Every sharded dimension must divide by the product of its axes'
    sizes. Returns the violations (empty: clean)."""
    sizes = mesh_axis_sizes(mesh)
    shapes = shapes_of(params_shape)
    specs = specs if specs is not None else param_specs(cfg, shapes, mesh)
    problems = []
    for name, spec in specs.items():
        for dim, entry in zip(shapes[name], spec):
            factor = 1
            for a in axes_of(entry):
                factor *= sizes[a]
            if dim % factor:
                problems.append(f"{name}: dim {dim} % {factor} != 0")
    return problems
