"""Laying a model, its train state and its cache out over a mesh by the
specs of :mod:`.strategy`, and back.

A dimension whose spec entry names axes is cut into that many equal
contiguous parts, the rank taking the part at its index along them (a
tuple of axes: the first axis major), as jax lays out a sharded array.

**The fused gate|up dimension.** A dense MLP's ``wi`` (d, 2·ff) and an MoE's
per-expert ``w_in`` (E, d, 2·ffe) hold the gate's columns and then the up
projection's. Their last dimension is split over ``model`` (``wi`` always,
``w_in`` when the experts are not), and a contiguous cut would hand rank 0
only gates at tp 2. The spec stays the reference's (the same sizes and
audit); each rank's shard is laid out as its own part of the gate followed
by its own part of the up projection, so the layer's ``chunk(2)`` splits a
shard as it splits the whole tensor. :func:`shard_tensor` and
:func:`gather_tensor` permute that dimension (``fused_last``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import collectives
from .strategy import P, axes_of, opt_state_specs, param_spec, param_specs

FUSED = ("wi", "w_in")   # tensors whose last dimension is gate | up


def is_fused(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in FUSED


def _interleave(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """[gate | up] → [gate_0 | up_0 | gate_1 | up_1 | …] in n parts."""
    f = t.shape[dim] // (2 * n)
    return t.unflatten(dim, (2, n, f)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def _deinterleave(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    f = t.shape[dim] // (2 * n)
    return t.unflatten(dim, (n, 2, f)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def shard_tensor(t: torch.Tensor, spec: P, mesh, rank: int | None = None,
                 fused_last: bool = False) -> torch.Tensor:
    """This rank's (or ``rank``'s) shard of a whole tensor, as a tensor of
    its own (the whole one can be freed)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    out = t
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if out.shape[dim] % (2 * n if fused_last and dim == t.dim() - 1 else n):
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
        if fused_last and dim == t.dim() - 1:
            out = _interleave(out, dim, n)
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes, rank) * size, size)
    return out.clone(memory_format=torch.contiguous_format) if out is not t else t


def gather_tensor(t: torch.Tensor, spec: P, mesh, fused_last: bool = False) -> torch.Tensor:
    """The whole tensor from every rank's shard (all-gathers over each
    sharded dimension's axes; every rank must call it)."""
    out = t
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        out = collectives.all_gather(out, axes, dim, mesh)
        if fused_last and dim == t.dim() - 1:
            out = _deinterleave(out, dim, mesh.axis_size(axes))
    return out


def shard_params(model, mesh):
    """The model's parameters replaced, in place, by this rank's shards
    under ``strategy.param_specs`` (``cfg.fsdp_params`` decides FSDP).
    Returns the model."""
    specs = param_specs(model.cfg, model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, specs[name], mesh, fused_last=is_fused(name))
    return model


def gather_params(model, mesh) -> dict[str, torch.Tensor]:
    """Name → whole tensor of a model whose parameters are this rank's
    shards (every rank must call it)."""
    specs = param_specs(model.cfg, model, mesh)   # a spec reads a name and a rank only
    with torch.no_grad():
        return {k: gather_tensor(p.detach(), specs[k], mesh, is_fused(k))
                for k, p in model.named_parameters()}


def zero_dim(pspec: P, ospec: P) -> tuple[int, tuple[str, ...]] | None:
    """The dimension ZeRO-1 splits further for the moments (the one whose
    optimizer-state axes extend the parameter's) and the extra axes, or
    None when the moments are laid out as the parameter."""
    found = None
    for dim, (pe, oe) in enumerate(zip(pspec, ospec)):
        pa, oa = axes_of(pe), axes_of(oe)
        if pa == oa:
            continue
        if oa[:len(pa)] != pa or found is not None:
            raise ValueError(f"moments {ospec} do not extend parameter {pspec}")
        found = (dim, oa[len(pa):])
    return found


def zero_slice(t: torch.Tensor, pspec: P, ospec: P, mesh) -> torch.Tensor:
    """This rank's ZeRO-1 part of a parameter-shaped local tensor (a view)."""
    z = zero_dim(pspec, ospec)
    if z is None:
        return t
    dim, axes = z
    size = t.shape[dim] // mesh.axis_size(axes)
    return t.narrow(dim, mesh.axis_index(axes) * size, size)


def zero_unslice(part: torch.Tensor, pspec: P, ospec: P, mesh) -> torch.Tensor:
    """The parameter-shaped local tensor from every rank's ZeRO-1 part."""
    z = zero_dim(pspec, ospec)
    if z is None:
        return part
    dim, axes = z
    return collectives.all_gather(part, axes, dim, mesh)


def gather_train_state(cfg: ModelConfig, state: dict, mesh) -> dict:
    """``{"params", "m", "v"[, "ef_error"]}``: name → whole tensor of a
    sharded train state (every rank must call it)."""
    out = {"params": gather_params(state["params"], mesh)}
    ospec = opt_state_specs(cfg, out["params"], mesh)
    keys = ["m", "v"] + (["ef_error"] if "ef_error" in state else [])
    for key in keys:
        tree = state["opt"][key] if key in ("m", "v") else state[key]
        out[key] = {k: gather_tensor(t, ospec[k], mesh, is_fused(k)) for k, t in tree.items()}
    return out


def init_sharded_params(cfg: ModelConfig, generator: torch.Generator, mesh,
                        device: str | torch.device | None = None):
    """``models.init_params`` with only this rank's shards kept: every
    tensor is drawn in order from ``generator`` (the same draws as the
    whole model's) and cut as soon as its layer is drawn, so no rank holds
    more than one layer whole."""
    from ..models.transformer import init_params

    def place(name: str, t: torch.Tensor) -> torch.Tensor:
        return shard_tensor(t, param_spec(cfg, name, t.dim(), mesh), mesh,
                            fused_last=is_fused(name))

    return init_params(cfg, generator, device, place=place)
