"""RMSNorm (+ optional residual add): the counterpart of
``repro.kernels.rmsnorm``.

On CPU tensors :func:`rmsnorm` runs the plain version (``ref.rmsnorm``); on
CUDA tensors it launches the hand-written kernels of ``csrc/rmsnorm.cu``,
which cover both Pallas kernels (``_rmsnorm_kernel`` and, with a residual,
``_rmsnorm_res_kernel``), or raises. One launch per call, counted under
``rmsnorm`` (and ``rmsnorm/residual`` with a residual). The vector kernel
takes rows it may copy 16 bytes at a time (:func:`vector_ok`); any other
row takes the scalar kernel, counted under ``rmsnorm/scalar``.

:class:`RMSNorm` is its ``torch.autograd.Function``. The JAX package has no
gradient for its Pallas RMSNorm (``jax.grad`` through it fails to
linearise) and trains only under its XLA dispatch, differentiating
``ref.rmsnorm``; no TPU backward kernel exists to port. So the Function's
forward is the kernel (or the plain version) and its backward is the
closed-form derivative in PyTorch ops (:func:`rmsnorm_bwd`), the same
derivative the reference's XLA path takes.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import on_cpu
from .. import native
from ..native import ptr
from . import cuda, ref

DTYPES = (torch.float32, torch.bfloat16)
# The vector kernel's shared memory with one warp at most (csrc/rmsnorm.cu:
# kMaxSmem): w, and two buffers of a row (of x, and of the residual).
VECTOR_MAX_SMEM = 200 << 10


def vector_ok(x: torch.Tensor, w: torch.Tensor, residual: torch.Tensor | None,
              out: torch.Tensor) -> bool:
    """Whether the vector kernel takes these contiguous tensors: every one
    starts on 16 bytes, the row length d is a multiple of 8, and w with two
    row buffers fits in ``VECTOR_MAX_SMEM``."""
    d = x.shape[-1]
    tensors = (x, w, out) if residual is None else (x, w, out, residual)
    smem = d * w.element_size() + 2 * d * x.element_size() * (1 if residual is None else 2)
    return (d % 8 == 0 and smem <= VECTOR_MAX_SMEM
            and all(t.data_ptr() % 16 == 0 for t in tensors))


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
    vec = vector_ok(x, w, residual, out)
    variant = ("residual",) * (residual is not None) + ("scalar",) * (not vec)
    native.launch("rmsnorm", "sc_rmsnorm", x.device,
                  ptr(x), ptr(residual), ptr(w), ptr(out),
                  ctypes.c_longlong(rows), ctypes.c_int(d),
                  ctypes.c_int(cuda.DTYPE_CODES[x.dtype]),
                  ctypes.c_int(cuda.DTYPE_CODES[w.dtype]), ctypes.c_float(eps),
                  ctypes.c_int(int(vec)), variant=variant)
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """Normalise the last axis of ``x`` (``(..., d)``, f32 or bf16, with
    ``residual`` added first when given) and scale by ``w`` (``(d,)``);
    f32 arithmetic, result in x's type."""
    if on_cpu(x, w, residual):
        return ref.rmsnorm(x, w, eps=eps, residual=residual)
    return _rmsnorm_cuda(x, w, eps, residual)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
                residual: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rmsnorm` for the output gradient ``dy``, in
    f32: with ``x̂ = x·r``, ``r = rsqrt(mean(x²) + eps)`` and ``g = dy ⊙ w``,
    ``dx = r·(g - x̂·mean(g ⊙ x̂))`` and ``dw = Σ_rows dy ⊙ x̂``. ``dx`` is in
    x's type (and is the residual's gradient too), ``dw`` in w's."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    g = dyf * w.float()
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with :func:`rmsnorm_bwd` as its gradient; it saves
    ``x``, ``w`` and the residual and recomputes the rsqrt."""

    @staticmethod
    def forward(ctx, x, w, eps: float, residual):
        ctx.save_for_backward(x, w, residual)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, w, residual = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps, residual)
        return dx, dw, None, None if residual is None else dx
