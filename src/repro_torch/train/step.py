"""Train-step factory: microbatched gradient accumulation, the remat
policy, the AdamW update; the counterpart of ``repro.train.step``.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``:
the model's parameters (a module, updated in place) and the moments keyed
by the parameters' names. Gradient compression (``compress_grads``) and the
sharding specs belong to the sharding slice of the port.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import Transformer, lm_loss
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def init_train_state(cfg: ModelConfig, params: Transformer,
                     compress_grads: bool = False) -> dict:
    """The model, made trainable (``requires_grad_``), with zero AdamW
    moments in ``cfg.opt_state_dtype``."""
    if compress_grads:
        raise NotImplementedError("gradient compression comes with the sharding "
                                  "slice of the port")
    params.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()), cfg.opt_state_dtype)}


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
    the loss is the microbatches' mean. Metrics are f32 scalar tensors
    ``loss``, ``grad_norm`` and ``lr``."""
    if compress_grads:
        raise NotImplementedError("gradient compression comes with the sharding "
                                  "slice of the port")

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
        _, new_opt, om = adamw_update(opt, params, gsum, state["opt"])
        new_state = dict(state)
        new_state["opt"] = new_opt
        return new_state, {"loss": lsum / n_micro, **om}

    return train_step
