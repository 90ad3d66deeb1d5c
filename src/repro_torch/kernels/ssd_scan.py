"""The Mamba-2 SSD chunked scan: the counterpart of
``repro.kernels.ssd_scan``.

On CPU tensors :func:`ssd_scan` runs the plain version
(``ref.ssd_scan_chunked``); on CUDA tensors it calls the hand-written
kernels of ``csrc/ssd_scan.cu`` (chunk state, state passing, chunk output:
one C entry, counted as one launch under ``ssd_scan``), or raises. The
kernels take x, dt, B and C with any strides as long as each row is
contiguous, so the model's B and C, the two halves of one (b, s, 2n)
tensor, reach them without a copy. With ``return_state`` the scan also
gives the f32 state after the last chunk, the Mamba-2 decode state.

The chunk states live in a workspace this wrapper allocates (the caching
allocator holds it): per (row, chunk, head) p·n f32 states, for bf16 inputs
the p·n bf16 states before each chunk, and L f32 of cum
(:func:`workspace_floats`), at most ``WORKSPACE_BYTES``;
:func:`workspace_plan` splits the batch rows into groups, and one row's
chunks into segments, to keep it there.

There is no gradient: the reference's Pallas scan has none (``jax.grad``
through it fails), and a ctypes launch is invisible to autograd. So the
wrapper refuses, on either device, inputs that would record a graph.
"""
from __future__ import annotations

import ctypes

import torch

from .. import native
from ..device import on_cpu
from ..native import ptr
from . import cuda, ref

DTYPES = (torch.float32, torch.bfloat16)
DEFAULT_CHUNK = 64
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
WORKSPACE_BYTES = 2 << 30


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, chunk: int) -> int:
    """The chunk length the scan takes (``min(chunk, s)``), after checking
    shapes, dtypes and that no input records a graph."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, expected (b, s, h, p)")
    b, s, h, _ = x.shape
    n = bmat.shape[-1]
    if dt.shape != (b, s, h) or a.shape != (h,) or bmat.shape != (b, s, n) \
            or cmat.shape != (b, s, n):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, bmat, cmat)):
        raise TypeError(f"ssd_scan: x, dt, B, C must share one dtype of {DTYPES}")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a is {a.dtype}, must be float32")
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} does not divide into chunks of {chunk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, bmat, cmat)):
        raise NotImplementedError("ssd_scan has no gradient: Mamba-2 training comes "
                                  "with a later slice of the port")
    return chunk


def workspace_floats(slots: int, p: int, n: int, chunk: int, bf16: bool) -> int:
    """Floats of the kernels' workspace for ``slots`` (row, chunk, head)
    triples, as ``csrc/ssd_scan.cu:carve`` lays it out: the f32 chunk states
    (p·n each), for bf16 inputs the bf16 states before each chunk (rows of n
    rounded up to 8), and cum (chunk each), each region on 16 bytes."""
    def on16(floats: int) -> int:
        return -(-floats // 4) * 4
    n8 = -(-n // 8) * 8
    return (on16(slots * p * n) + (on16(slots * p * n8 // 2) if bf16 else 0)
            + slots * chunk)


def workspace_plan(b: int, s: int, h: int, p: int, n: int, chunk: int, bf16: bool
                   ) -> tuple[int, int]:
    """``(group_rows, seg_chunks)``: the batch rows the kernels take at a
    time and the chunks of one row they take at a time, so that the
    workspace (:func:`workspace_floats`) stays within ``WORKSPACE_BYTES``.
    A row is cut into segments only when one row alone does not fit."""
    limit = WORKSPACE_BYTES - 64   # the regions' alignment
    nc = s // chunk
    per_chunk = 4 * workspace_floats(h, p, n, chunk, bf16)
    if nc * per_chunk > limit:
        return 1, max(1, limit // per_chunk)
    return max(1, min(b, limit // (nc * per_chunk))), nc


def _ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {chunk}, head dim {p}, state {n} beyond "
                         f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    if b > 65535:
        raise ValueError("ssd_scan: batch must be < 65536")
    if x.stride(3) != 1 or bmat.stride(2) != 1 or cmat.stride(2) != 1:
        raise ValueError("ssd_scan: x, B, C rows must be contiguous")
    a = a.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h_final.zero_()
    bf16 = x.dtype == torch.bfloat16
    rows, seg = workspace_plan(b, s, h, p, n, chunk, bf16)
    ws = torch.empty(workspace_floats(rows * seg * h, p, n, chunk, bf16),
                     dtype=torch.float32, device=x.device)
    flat = [*x.stride()[:3], *dt.stride(), *bmat.stride()[:2], *cmat.stride()[:2]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    native.launch("ssd_scan", "sc_ssd_scan", x.device,
                  ptr(x), ptr(dt), ptr(a), ptr(bmat), ptr(cmat), ptr(y), ptr(h_final), ptr(ws),
                  *(ctypes.c_int(v) for v in (b, s, h, p, n, chunk, rows, seg)),
                  ctypes.cast(strides, ctypes.c_void_p),
                  ctypes.c_int(cuda.DTYPE_CODES[x.dtype]))
    return y, h_final


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = DEFAULT_CHUNK, return_state: bool = False
             ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``y`` (b, s, h, p) in x's type of the SSD scan over x (b, s, h, p),
    dt (b, s, h), a (h,) f32 and B, C (b, s, n), in chunks of
    ``min(chunk, s)`` positions, which must divide s (``ValueError``); with
    ``return_state``, ``(y, h_final)``, h_final (b, h, p, n) f32 the state
    after the last chunk. x, dt, B and C share f32 or bf16; the arithmetic
    is f32 (bf16 inputs: the tensor-core products of ``csrc/ssd_scan.cu``).
    Raises ``NotImplementedError`` when an input requires grad under grad
    mode."""
    chunk = _check(x, dt, a, bmat, cmat, chunk)
    if on_cpu(x, dt, a, bmat, cmat):
        out = ref.ssd_scan_chunked(x, dt, a, bmat, cmat, chunk=chunk, return_state=True)
    else:
        out = _ssd_cuda(x, dt, a, bmat, cmat, chunk)
    return out if return_state else out[0]
