"""Public model-kernel entry points, the counterpart of
``repro.kernels.ops``.

Dispatch is by the device of the tensors and nothing else: CPU tensors take
the plain version, CUDA tensors the hand-written kernel (or the wrapper
raises). There is no ``impl`` argument. ``rmsnorm`` and
``flash_attention`` are differentiable through their
``torch.autograd.Function`` (the flash backward kernels; RMSNorm's
closed-form gradient); under ``torch.inference_mode()`` they launch exactly
their forward kernel. ``ssd_scan`` is ``kernels.ssd_scan.ssd_scan``
itself: differentiable through ``SSDScan`` (the scan kernels forward, the
chunked scan's closed-form gradient in PyTorch ops backward) when an input
requires grad under grad mode, else exactly one forward launch.
``launches`` counts each kernel's launches (``variant_launches`` the
residual RMSNorm's share); the wrappers bump it where they launch and
nowhere else.
"""
from __future__ import annotations

import torch

from .cuda import KERNELS, launches, reset_launches, variant_launches
from .flash_attention import FlashAttention
from .rmsnorm import RMSNorm
from .ssd_scan import ssd_scan

__all__ = ["rmsnorm", "flash_attention", "ssd_scan", "KERNELS", "launches",
           "variant_launches", "reset_launches"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention output only (see ``flash_attention_fwd``), differentiable
    in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, scale)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """RMSNorm of ``x`` (plus ``residual``) scaled by ``w`` (see
    ``kernels.rmsnorm.rmsnorm``), differentiable in x, w and residual."""
    return RMSNorm.apply(x, w, eps, residual)
