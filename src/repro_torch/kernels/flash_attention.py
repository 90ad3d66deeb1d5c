"""Flash attention, forward and backward: the counterpart of
``repro.kernels.flash_attention`` (``flash_attention_fwd``,
``flash_attention_bwd`` and the ``jax.custom_vjp`` ``flash_attention``).

On CPU tensors :func:`flash_attention_fwd` and :func:`flash_attention_bwd`
run the plain versions (``ref.attention_with_lse``, ``ref.attention_bwd``);
on CUDA tensors they launch the hand-written kernels (one launch each of
``flash_fwd``, and of ``flash_bwd_dq`` and ``flash_bwd_dkv``), or raise.
:func:`variant` picks the kernel of each from the dtype and the head width
alone, before the launch: bf16 up to ``MMA_MAX_HEAD_DIM`` takes the
tensor-core kernels of ``csrc/flash_attention_mma.cu`` (variant ``mma``),
everything else the CUDA-core kernels of ``csrc/flash_attention.cu``
(``cuda_core``). The kernels take q, k, v and do with any batch,
head and row strides as long as each row is contiguous, so the model's
transposed views, and the transposed gradient autograd hands the backward,
reach them without a copy (every kernel copies rows 16 bytes at a time
where they start on 16 bytes, element by element otherwise: the ``mma``
kernels are told so by :func:`cp_async_aligned`, the CUDA-core entries
test the pointers and strides themselves).
:class:`FlashAttention` is the ``torch.autograd.Function`` around the pair:
its forward saves ``q, k, v, o, lse``; its backward computes
``δ = rowsum(do ⊙ o)`` in PyTorch, as the reference does in jnp outside its
kernels, and returns ``dk`` and ``dv`` in k's own kv-head layout (the dkv
kernel sums each kv head's query heads itself).
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
# The widest head each tensor-core kernel holds: every one up to 256 (dk/dv
# above 128 splits its two accumulators' columns between two warps), so
# every bf16 launch takes the tensor cores and every f32 one the CUDA cores.
MMA_MAX_HEAD_DIM = {"flash_fwd": 256, "flash_bwd_dq": 256, "flash_bwd_dkv": 256}
# The C entry point of each (kernel, variant).
_ENTRY = {("flash_fwd", "mma"): "sc_flash_fwd_mma",
          ("flash_fwd", "cuda_core"): "sc_flash_fwd",
          ("flash_bwd_dq", "mma"): "sc_flash_bwd_dq_mma",
          ("flash_bwd_dq", "cuda_core"): "sc_flash_bwd_dq",
          ("flash_bwd_dkv", "mma"): "sc_flash_bwd_dkv_mma",
          ("flash_bwd_dkv", "cuda_core"): "sc_flash_bwd_dkv"}


def variant(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The kernel a launch of ``kernel`` (``flash_fwd``, ``flash_bwd_dq`` or
    ``flash_bwd_dkv``) takes for inputs of ``dtype`` and head width ``d``: ``"mma"`` (bf16
    tensor cores) for bf16 up to ``MMA_MAX_HEAD_DIM[kernel]``, else
    ``"cuda_core"`` (f32 FMAs)."""
    if dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM[kernel]:
        return "mma"
    return "cuda_core"


def cp_async_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every row of each (b, h, s, d) tensor starts on 16 bytes: the
    base address and the batch, head and row strides (those of dimensions
    longer than 1) are multiples of 16 bytes. Only then may the ``mma``
    kernels copy rows with 16-byte ``cp.async``."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(n > 1 and stride * size % 16
                                    for n, stride in zip(t.shape[:3], t.stride()[:3])):
            return False
    return True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (b, hq, sq, d) and two "
                         "equal (b, hkv, sk, d)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: kv {tuple(k.shape)} does not fit q {tuple(q.shape)}")


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """Batch, head and row strides of each (b, h, s, d) tensor, in elements,
    for a C entry point; each row must be contiguous."""
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError("flash_attention: q, k, v rows must be contiguous")
    flat = [n for t in tensors for n in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of {DTYPES}")
    b, hq, _, d = q.shape
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_HEAD_DIM}")
    if b > 65535 or hq > 65535:
        raise ValueError("flash_attention: batch and heads must be < 65536")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    _check_cuda(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = _strides(q, k, v)
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    kind = variant("flash_fwd", q.dtype, d)
    native.launch("flash_fwd", _ENTRY["flash_fwd", kind], q.device,
                  ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                  *(ctypes.c_int(n) for n in (b, hq, hkv, sq, sk, d)),
                  ctypes.cast(strides, ctypes.c_void_p), ctypes.c_float(scale),
                  ctypes.c_int(int(causal)), _last_arg(kind, q, k, v),
                  variant=kind)
    return o, lse


def _last_arg(kind: str, *inputs: torch.Tensor) -> ctypes.c_int:
    """The entry point's last argument before the stream: the ``mma``
    kernels' alignment flag, the CUDA-core kernels' dtype code."""
    if kind == "mma":
        return ctypes.c_int(int(cp_async_aligned(*inputs)))
    return ctypes.c_int(cuda.DTYPE_CODES[inputs[0].dtype])


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


def _launch_bwd(kernel: str, q, k, v, do, lse, delta, causal: bool, scale: float,
                *outputs: torch.Tensor) -> None:
    """One launch of a backward kernel, of the variant :func:`variant` picks,
    writing ``outputs`` (``lse`` and ``delta`` contiguous f32; the rest
    checked by the caller)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = _strides(q, k, v, do)
    kind = variant(kernel, q.dtype, d)
    native.launch(kernel, _ENTRY[kernel, kind], q.device,
                  ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                  *(ptr(t) for t in outputs),
                  *(ctypes.c_int(n) for n in (b, hq, hkv, sq, sk, d)),
                  ctypes.cast(strides, ctypes.c_void_p), ctypes.c_float(scale),
                  ctypes.c_int(int(causal)), _last_arg(kind, q, k, v, do),
                  variant=kind)


def _launch_dq(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    """dq from one ``flash_bwd_dq`` launch of the kernel :func:`variant`
    picks (none when q is empty)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, causal, scale, dq)
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, scale: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """dk, dv from one ``flash_bwd_dkv`` launch of the kernel
    :func:`variant` picks (none when k is empty)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, causal, scale, dk, dv)
    return dk, dv


def _bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, do: torch.Tensor, causal: bool, scale: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_cuda(q, k, v)
    if do.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: do is {do.dtype}, q {q.dtype}")
    if do.stride(3) != 1:  # e.g. an expanded gradient: one copy, rows contiguous
        do = do.contiguous()
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1)          # (b, hq, sq) f32, contiguous
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *_launch_dkv(q, k, v, do, lse, delta, causal, scale))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the output
    gradient ``do`` (q's shape and type), from its saved ``o`` and ``lse``:
    dq in q's layout, dk and dv in k's (summed over each kv head's query
    heads), each in its input's type, f32 accumulation."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if on_cpu(q, k, v, o, lse, do):
        return ref.attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    return _bwd_cuda(q, k, v, o, lse, do, causal, scale)


class FlashAttention(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the flash backward as its gradient:
    the counterpart of the ``jax.custom_vjp`` at ``flash_attention.py:325``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None
