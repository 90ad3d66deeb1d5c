"""RMSNorm (+ optional residual add): the counterpart of
``repro.kernels.rmsnorm``.

On CPU tensors :func:`rmsnorm` runs the plain version (``ref.rmsnorm``); on
CUDA tensors it launches the hand-written kernel of ``csrc/rmsnorm.cu``,
which covers both Pallas kernels (``_rmsnorm_kernel`` and, with a residual,
``_rmsnorm_res_kernel``), or raises. One launch per call, counted under
``rmsnorm`` (and ``rmsnorm/residual``).
"""
from __future__ import annotations

import ctypes

import torch

from ..device import on_cpu
from .. import native
from ..native import ptr
from . import cuda, ref

DTYPES = (torch.float32, torch.bfloat16)


def _rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float,
                  residual: torch.Tensor | None) -> torch.Tensor:
    d = x.shape[-1]
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x {x.dtype} and w {w.dtype} must be in {DTYPES}")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w has shape {tuple(w.shape)}, expected ({d},)")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("rmsnorm: residual must match x in shape and dtype")
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out
    native.launch("rmsnorm", "sc_rmsnorm", x.device,
                  ptr(x), ptr(residual), ptr(w), ptr(out),
                  ctypes.c_longlong(rows), ctypes.c_int(d),
                  ctypes.c_int(cuda.DTYPE_CODES[x.dtype]),
                  ctypes.c_int(cuda.DTYPE_CODES[w.dtype]), ctypes.c_float(eps),
                  variant=None if residual is None else "residual")
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """Normalise the last axis of ``x`` (``(..., d)``, f32 or bf16, with
    ``residual`` added first when given) and scale by ``w`` (``(d,)``);
    f32 arithmetic, result in x's type."""
    if on_cpu(x, w, residual):
        return ref.rmsnorm(x, w, eps=eps, residual=residual)
    return _rmsnorm_cuda(x, w, eps, residual)
