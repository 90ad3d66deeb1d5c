"""Train-step factory: microbatched gradient accumulation, the remat
policy, optional int8 error-feedback gradient compression, the AdamW
update; the counterpart of ``repro.train.step``.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``:
the model's parameters (a module, updated in place) and the moments keyed
by the parameters' names; with ``compress_grads`` also ``"ef_error"``, the
f32 compression errors under the same names. The sharding specs
(``train_state_specs``) and ``make_train_step(dp=)`` belong to the
sharding slice of the port.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import Transformer, lm_loss
from ..sharding import compression
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def init_train_state(cfg: ModelConfig, params: Transformer,
                     compress_grads: bool = False) -> dict:
    """The model, made trainable (``requires_grad_``), with zero AdamW
    moments in ``cfg.opt_state_dtype`` and, with ``compress_grads``, zero
    f32 compression errors (``ef_error``) keyed as the moments."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
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


def _num_microbatches(cfg: ModelConfig, global_rows: int) -> int:
    n_micro = max(global_rows // max(cfg.microbatch_size, 1), 1)
    while global_rows % n_micro != 0:  # keep the split exact
        n_micro -= 1
    return max(n_micro, 1)


def make_train_step(
    cfg: ModelConfig,
    opt: AdamWConfig = AdamWConfig(),
    global_rows: int | None = None,
    save_names: tuple[str, ...] = (),
    compress_grads: bool = False,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (rows, seq) on the model's
    device. Microbatch ``i`` takes the strided rows ``rows[i::n_micro]`` (the
    reference's reshape and swapaxes, ``step.py:72-75``); each one's
    gradients are cast to f32 and summed, then divided by ``n_micro``, and
    the loss is the microbatches' mean. With ``compress_grads`` the
    averaged f32 gradients go through ``compression.ef_compress_tree``
    against the state's ``ef_error`` before the update, which then sees
    (and clips, and reports the norm of) the dequantized gradients; the
    layers the JAX package stacks into one leaf share one scale
    (:func:`_stacked_leaves`), as there. Metrics are f32 scalar tensors
    ``loss``, ``grad_norm`` and ``lr``."""

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = dict(model.named_parameters())
        rows = batch["tokens"].shape[0]
        n_micro = _num_microbatches(cfg, global_rows or rows)
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
        if compress_grads:
            gsum, new_state["ef_error"] = compression.ef_compress_tree(
                gsum, state["ef_error"], _stacked_leaves(cfg, gsum))
        _, new_opt, om = adamw_update(opt, params, gsum, state["opt"])
        new_state["opt"] = new_opt
        return new_state, {"loss": lsum / n_micro, **om}

    return train_step
