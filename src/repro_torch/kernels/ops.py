"""Public model-kernel entry points, the counterpart of
``repro.kernels.ops``.

Dispatch is by the device of the tensors and nothing else: CPU tensors take
the plain version, CUDA tensors the hand-written kernel (or the wrapper
raises). There is no ``impl`` argument. ``launches`` counts each kernel's
launches (``variant_launches`` the residual RMSNorm's share); the wrappers
bump it where they launch and nowhere else.
"""
from __future__ import annotations

import torch

from .cuda import KERNELS, launches, reset_launches, variant_launches
from .flash_attention import flash_attention_fwd
from .rmsnorm import rmsnorm

__all__ = ["rmsnorm", "flash_attention", "KERNELS", "launches",
           "variant_launches", "reset_launches"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention output only; see :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
