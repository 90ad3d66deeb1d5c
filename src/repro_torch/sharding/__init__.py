"""Sharding over a mesh of ``torch.distributed`` ranks: the counterpart of
``repro.sharding`` (the strategy's specs, the mesh context, int8 gradient
compression) and the port's own collectives and layout of tensors over a
mesh."""
from . import collectives, compression, context, layout
from .layout import NamedSharding
from .strategy import (
    PartitionSpec,
    activation_sharding_constraint,
    audit_divisibility,
    batch_specs,
    cache_specs,
    dp_axes,
    mesh_axis_sizes,
    opt_state_specs,
    param_specs,
)

__all__ = [
    "collectives",
    "compression",
    "context",
    "layout",
    "NamedSharding",
    "PartitionSpec",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "dp_axes",
    "mesh_axis_sizes",
    "audit_divisibility",
    "activation_sharding_constraint",
]
