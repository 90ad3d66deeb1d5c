"""AdamW as plain functions on a name → tensor mapping: the counterpart of
``repro.train.optimizer``.

The math is the reference's: the update runs in f32 whatever the
parameters' and moments' types, the gradient is clipped by its global norm,
the learning rate warms up linearly, and weight decay sits inside ``delta``
(``torch.optim.AdamW`` decays before the moment update and would not match).
Moments are kept in ``opt_state_dtype``. The JAX package returns new
arrays; the port updates parameters and moments in place, so the card
holds one copy of the state (for stablelm-3b: 5.6 GB of bf16 parameters,
22.4 GB of f32 moments).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def lr_at(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """``lr · min(step / warmup_steps, 1)`` as an f32 scalar tensor."""
    warm = torch.clamp(step.float() / max(opt.warmup_steps, 1), max=1.0)
    return opt.lr * warm


def init_opt_state(params: Mapping[str, torch.Tensor], dtype: str = "float32") -> dict:
    """Zero moments ``m`` and ``v`` (``dtype``) beside each parameter, and
    an int32 ``step`` of 0, on the parameters' device."""
    dt = getattr(torch, dtype)
    first = next(iter(params.values()))
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every tensor, in f32."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.float())) for g in tree.values()]).sum())


@torch.no_grad()
def adamw_update(opt: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict
                 ) -> tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step: parameters and moments are updated in place; returns
    ``(params, {"m", "v", "step"}, {"grad_norm", "lr"})`` with the new step
    count."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(opt.grad_clip / (gn + 1e-9), max=1.0)
    lr = lr_at(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * g * g
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps) + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gn, "lr": lr}
