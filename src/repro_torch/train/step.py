"""Train-step factory: microbatched gradient accumulation, the remat
policy, optional int8 error-feedback gradient compression, the AdamW
update; the counterpart of ``repro.train.step``.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``:
the model's parameters (a module, updated in place) and the moments keyed
by the parameters' names; with ``compress_grads`` also ``"ef_error"``, the
f32 compression errors under the same names. ``train_state_specs`` gives
that structure's specs over a mesh; with a mesh set
(``sharding.context``), the state holds the rank's shards: the model's by
``param_specs``, the moments and errors by ``opt_state_specs`` (ZeRO-1).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import Transformer, lm_loss
from ..sharding import collectives as C
from ..sharding import compression
from ..sharding.context import get_mesh
from ..sharding.layout import zero_dim, zero_slice, zero_unslice
from ..sharding.strategy import P, axes_of, dp_axes, opt_state_specs, param_specs
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def init_train_state(cfg: ModelConfig, params: Transformer,
                     compress_grads: bool = False) -> dict:
    """The model, made trainable (``requires_grad_``), with zero AdamW
    moments in ``cfg.opt_state_dtype`` and, with ``compress_grads``, zero
    f32 compression errors (``ef_error``) keyed as the moments. On a mesh
    the model holds the rank's shards and the moments and errors take the
    rank's ZeRO-1 part of each."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    mesh = get_mesh()
    if mesh is not None:
        pspec, ospec = _specs(params.cfg, named, mesh)
        named = {k: zero_slice(p.detach(), pspec[k], ospec[k], mesh) for k, p in named.items()}
    state = {"params": params, "opt": init_opt_state(named, cfg.opt_state_dtype)}
    if compress_grads:
        state["ef_error"] = compression.init_error_state(named)
    return state


def _stacked_leaves(cfg: ModelConfig, names) -> dict[str, str]:
    """Each parameter's leaf in the JAX package's parameter tree, which
    stacks layer ``g · len(cfg.pattern) + i`` of every group g into one
    leaf (``blocks.sub{i}.…``): gradient compression takes one scale a
    leaf, so the port groups those layers' tensors under one key."""
    out = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head == "layers":
            n, _, rest = rest.partition(".")
            out[name] = f"sub{int(n) % len(cfg.pattern)}.{rest}"
        else:
            out[name] = name
    return out


def _num_microbatches(cfg: ModelConfig, global_rows: int, dp: int = 1) -> int:
    """Microbatches a step: the rows a device holds (``global_rows / dp``)
    over ``cfg.microbatch_size``, lowered until it divides ``global_rows``
    (``step.py:30``)."""
    per_dev = max(global_rows // max(dp, 1), 1)
    n_micro = max(per_dev // max(cfg.microbatch_size, 1), 1)
    while global_rows % n_micro != 0:  # keep the split exact
        n_micro -= 1
    return max(n_micro, 1)


def _specs(cfg: ModelConfig, named, mesh) -> tuple[dict[str, P], dict[str, P]]:
    return param_specs(cfg, named, mesh), opt_state_specs(cfg, named, mesh)


def _sharded_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of gradients held as shards laid out by ``specs``:
    each shard's square sum is counted on one rank of those holding it
    (index 0 along every axis its spec does not split), and the counts are
    summed over the mesh, so every shard and every replicated tensor counts
    once."""
    me = mesh.coords()
    total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for name, g in grads.items():
        split = {a for e in specs[name] for a in axes_of(e)}
        if all(i == 0 for a, i in me.items() if a not in split):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(C.all_reduce(total, tuple(mesh.axis_names), mesh=mesh))


def make_train_step(
    cfg: ModelConfig,
    opt: AdamWConfig = AdamWConfig(),
    dp: int = 1,
    global_rows: int | None = None,
    save_names: tuple[str, ...] = (),
    compress_grads: bool = False,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (rows, seq) on the model's
    device. ``dp`` and ``global_rows`` (default: the batch's rows, over
    every data rank on a mesh) fix the microbatch count
    (:func:`_num_microbatches`). Microbatch ``i`` takes the strided rows
    ``rows[i::n_micro]`` (the reference's reshape and swapaxes,
    ``step.py:72-75``); each one's
    gradients are cast to f32 and summed, then divided by ``n_micro``, and
    the loss is the microbatches' mean. With ``compress_grads`` the
    averaged f32 gradients go through ``compression.ef_compress_tree``
    against the state's ``ef_error`` before the update, which then sees
    (and clips, and reports the norm of) the dequantized gradients; the
    layers the JAX package stacks into one leaf share one scale
    (:func:`_stacked_leaves`), as there. Metrics are f32 scalar tensors
    ``loss``, ``grad_norm`` and ``lr``.

    **On a mesh** (``sharding.context``) the state holds the rank's shards
    and ``batch`` its data shard (``strategy.batch_specs``: data rank j
    holds global rows ``[j·R/dp, (j+1)·R/dp)``). Its strided rows
    ``[i::n_micro]`` are then its part of global microbatch i, and the
    loss is the global microbatch's (``models.lm_loss``). The gradients
    are summed over the data axes (an FSDP weight's already are: its
    gather's backward reduce-scatters), each rank updates its ZeRO-1 part
    of every parameter with its moments, and the parts are gathered back.
    The clipping norm counts every shard and every replicated tensor once;
    compression's scales are the maxima over every rank's shards of a
    stacked leaf."""

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = dict(model.named_parameters())
        rows = batch["tokens"].shape[0]
        mesh = get_mesh()
        n_dp = 1 if mesh is None else mesh.axis_size(dp_axes(mesh))
        n_micro = _num_microbatches(cfg, global_rows or rows * n_dp, dp)
        if rows % n_micro:
            raise ValueError(f"{rows} rows a rank do not split into {n_micro} microbatches")
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(n_micro):
            mb = {k: v[i::n_micro] for k, v in batch.items()}
            loss, _aux = lm_loss(cfg, model, mb, save_names=save_names)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for acc, g in zip(gsum.values(), grads):
                    acc.add_(g)
                lsum += loss.detach()
            del loss, grads
        if n_micro > 1:
            for acc in gsum.values():
                acc.div_(n_micro)
        new_state = dict(state)
        if mesh is not None:
            return _sharded_update(cfg, opt, compress_grads, params, gsum, state, new_state,
                                   lsum / n_micro, mesh)
        if compress_grads:
            gsum, new_state["ef_error"] = compression.ef_compress_tree(
                gsum, state["ef_error"], _stacked_leaves(cfg, gsum))
        _, new_opt, om = adamw_update(opt, params, gsum, state["opt"])
        new_state["opt"] = new_opt
        return new_state, {"loss": lsum / n_micro, **om}

    return train_step


@torch.no_grad()
def _sharded_update(cfg: ModelConfig, opt: AdamWConfig, compress_grads: bool, params: dict,
                    gsum: dict, state: dict, new_state: dict, loss: torch.Tensor, mesh):
    """The update of :func:`make_train_step` on a mesh: gradients summed
    over the data axes, compressed and clipped on the ZeRO-1 parts, each
    part updated and the parameters gathered back."""
    dpx = dp_axes(mesh)
    pspec, ospec = _specs(cfg, params, mesh)
    for name, g in gsum.items():
        if not any(axes_of(e) == dpx for e in pspec[name]):   # FSDP grads are summed
            gsum[name] = C.all_reduce(g, dpx, mesh=mesh)
    parts = {k: zero_slice(p.detach(), pspec[k], ospec[k], mesh) for k, p in params.items()}
    grads = {k: zero_slice(g, pspec[k], ospec[k], mesh) for k, g in gsum.items()}
    if compress_grads:
        grads, new_state["ef_error"] = compression.ef_compress_tree(
            grads, state["ef_error"], _stacked_leaves(cfg, grads),
            reduce_max=lambda t: C.all_reduce(t, tuple(mesh.axis_names), "max", mesh))
    norm = _sharded_norm(grads, ospec, mesh)
    _, new_state["opt"], om = adamw_update(opt, parts, grads, state["opt"], norm=norm)
    for k, p in params.items():
        if zero_dim(pspec[k], ospec[k]) is not None:
            p.detach().copy_(zero_unslice(parts[k], pspec[k], ospec[k], mesh))
    return new_state, {"loss": loss, **om}


def train_state_specs(cfg: ModelConfig, params_shape, mesh,
                      compress_grads: bool = False) -> dict:
    """Specs matching :func:`init_train_state`'s structure
    (``step.py:106``): ``params`` by ``param_specs``, the moments (and the
    compression errors) by ``opt_state_specs``, the step replicated."""
    pspec, ospec = _specs(cfg, params_shape, mesh)
    state_spec = {"params": pspec, "opt": {"m": ospec, "v": ospec, "step": P()}}
    if compress_grads:
        state_spec["ef_error"] = ospec
    return state_spec
