"""Flash-attention forward: the counterpart of
``repro.kernels.flash_attention.flash_attention_fwd``.

On CPU tensors :func:`flash_attention_fwd` runs the plain version
(``ref.attention_with_lse``); on CUDA tensors it launches the hand-written
kernel of ``csrc/flash_attention.cu`` (one launch, counted under
``flash_fwd``), or raises. The kernel takes q, k and v with any batch, head
and row strides as long as each row is contiguous, so the model's
transposed views reach it without a copy. The backward kernels and the
``torch.autograd.Function`` come with the training slice; on the serving
path the forward runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import on_cpu
from .. import native
from ..native import ptr
from . import cuda, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (b, hq, sq, d) and two "
                         "equal (b, hkv, sk, d)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: kv {tuple(k.shape)} does not fit q {tuple(q.shape)}")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of {DTYPES}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_HEAD_DIM}")
    if b > 65535 or hq > 65535:
        raise ValueError("flash_attention: batch and heads must be < 65536")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} rows must be contiguous")
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    native.launch("flash_fwd", "sc_flash_fwd", q.device,
                  ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                  *(ctypes.c_int(n) for n in (b, hq, hkv, sq, sk, d)),
                  ctypes.cast(strides, ctypes.c_void_p), ctypes.c_float(scale),
                  ctypes.c_int(int(causal)), ctypes.c_int(cuda.DTYPE_CODES[q.dtype]))
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of softmax attention: q (b, hq, sq, d), k/v
    (b, hkv, sk, d) with hq a multiple of hkv, f32 or bf16. ``o`` is in q's
    type, ``lse`` in f32 and +inf on a row with no unmasked column. Causal
    keeps ``col <= row`` from the top left; ``scale`` defaults to
    ``1/sqrt(d)``."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if on_cpu(q, k, v):
        return ref.attention_with_lse(q, k, v, causal=causal, scale=scale)
    return _flash_cuda(q, k, v, causal, scale)
