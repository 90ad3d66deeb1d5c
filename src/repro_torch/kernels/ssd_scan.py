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

:class:`SSDScan` is its ``torch.autograd.Function``. The JAX package has no
gradient for its Pallas scan (``jax.grad`` through it fails) and trains
Mamba-2 only under its XLA dispatch, differentiating
``ref.ssd_scan_chunked``; no TPU backward kernel exists to port. So the
Function's forward is the scan above (the kernels, or the plain version on
the CPU) and its backward is the closed-form derivative of the chunked scan
in PyTorch ops (:func:`ssd_scan_bwd`), the derivative the reference's XLA
path takes, as ``rmsnorm.RMSNorm`` does for RMSNorm. :func:`ssd_scan` takes
the Function only when grad mode is on and an input requires grad;
otherwise it is one forward launch.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

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
    shapes and dtypes."""
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
    return _plan(b, s // chunk, 4 * workspace_floats(h, p, n, chunk, bf16),
                 WORKSPACE_BYTES - 64)   # the regions' alignment


def _plan(b: int, nc: int, per_chunk: int, limit: int) -> tuple[int, int]:
    """``(group_rows, seg_chunks)`` for ``per_chunk`` bytes a (row, chunk)
    within ``limit`` bytes."""
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


def _scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
          cmat: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    if on_cpu(x, dt, a, bmat, cmat):
        return ref.ssd_scan_chunked(x, dt, a, bmat, cmat, chunk=chunk, return_state=True)
    return _ssd_cuda(x, dt, a, bmat, cmat, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = DEFAULT_CHUNK, return_state: bool = False
             ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``y`` (b, s, h, p) in x's type of the SSD scan over x (b, s, h, p),
    dt (b, s, h), a (h,) f32 and B, C (b, s, n), in chunks of
    ``min(chunk, s)`` positions, which must divide s (``ValueError``); with
    ``return_state``, ``(y, h_final)``, h_final (b, h, p, n) f32 the state
    after the last chunk, which takes no gradient. x, dt, B and C share f32
    or bf16; the arithmetic is f32 (bf16 inputs: the tensor-core products of
    ``csrc/ssd_scan.cu``). Differentiable in x, dt, a, B and C
    (:class:`SSDScan`) when grad mode is on and one of them requires grad."""
    chunk = _check(x, dt, a, bmat, cmat, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, bmat, cmat)):
        out = SSDScan.apply(x, dt, a, bmat, cmat, chunk)
    else:
        out = _scan(x, dt, a, bmat, cmat, chunk)
    return out if return_state else out[0]


# ---------------------------------------------------------------------------
# the gradient: the closed-form VJP of the chunked scan, in PyTorch ops
# ---------------------------------------------------------------------------

def bwd_floats(p: int, n: int, chunk: int) -> int:
    """Values of the arithmetic's type :func:`ssd_scan_bwd` holds at once
    for one (row, chunk, head): the state before the chunk, the chunk state
    (then its gradient), the gradient of the state before the chunk and a
    temporary (p·n each); the decay of the intra-chunk product, its
    gradient and their temporaries (four L×L); and ten L×p: x and dy in
    the arithmetic's type, x·dt, the per-head copies of x·dt and dy that
    the intra-chunk products take, the gradient of x·dt and temporaries."""
    return 4 * p * n + 4 * chunk * chunk + 10 * chunk * p


def bwd_plan(b: int, s: int, h: int, p: int, n: int, chunk: int,
             itemsize: int = 4) -> tuple[int, int]:
    """``(group_rows, seg_chunks)`` of :func:`ssd_scan_bwd`: the batch rows
    it takes at a time and the chunks of one row it takes at a time, so that
    its working set (:func:`bwd_floats` a (row, chunk, head), plus B, C,
    their gradients and two L×L tensors a (row, chunk), each value of
    ``itemsize`` bytes) stays within ``WORKSPACE_BYTES``."""
    per_chunk = itemsize * (h * bwd_floats(p, n, chunk) + 4 * chunk * n + 2 * chunk * chunk)
    return _plan(b, s // chunk, per_chunk, WORKSPACE_BYTES)


def _chunk_states(xdt: torch.Tensor, w: torch.Tensor, bm: torch.Tensor) -> torch.Tensor:
    """The chunk states ``S_c = Σ_j w_j·(x·dt)_j B_jᵀ`` (k, g, h, p, n) from
    xdt (k, g, L, h, p), w (k, g, L, h) and B (k, g, L, n): one product a
    (row, chunk) over all heads, ``(x·dt ⊙ w)ᵀ·B`` with rows h·p."""
    k, g, L, h, p = xdt.shape
    u = (xdt * w[..., None]).reshape(k, g, L, h * p)
    return torch.matmul(u.transpose(-1, -2), bm).view(k, g, h, p, -1)


def _recompute(xdt: torch.Tensor, dtf: torch.Tensor, af: torch.Tensor, bm: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The forward's ``(cum, w = exp(total - cum), exp(total) (k, g, h, 1,
    1), S_c, H_{c-1})`` through the chunks of :func:`_segment_bwd` from
    ``h0``, the state before the first: ``H_c = exp(total_c)·H_{c-1} + S_c``."""
    cum = torch.cumsum(dtf * af, dim=2)
    total = cum[:, :, -1]
    w = torch.exp(total[:, :, None] - cum)
    decay_c = torch.exp(total)[..., None, None]
    states = _chunk_states(xdt, w, bm)
    hpre = torch.empty_like(states)
    hpre[0] = h0
    for c in range(xdt.shape[0] - 1):
        torch.addcmul(states[c], hpre[c], decay_c[c], out=hpre[c + 1])
    return cum, w, decay_c, states, hpre


def _segment_bwd(xdt: torch.Tensor, dtf: torch.Tensor, af: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, dy: torch.Tensor, h0: torch.Tensor, dh_after: torch.Tensor
                 ) -> tuple[torch.Tensor, ...]:
    """The gradient through k chunks of g rows, chunk-major: xdt = x·dt and
    dy (k, g, L, h, p), dt (k, g, L, h), B and C (k, g, L, n), all of the
    arithmetic's type; ``h0`` (g, h, p, n) the state before the first
    chunk, ``dh_after`` the gradient of the state after the last. Returns
    ``(dxdt (k, g, L, h, p), dcum (k, g, L, h), dB, dC (k, g, L, n),
    dh_before)``: ``dcum`` the gradient of the within-chunk cumsum of dt·a,
    ``dh_before`` that of ``h0``. The products with B, C and the states
    take all heads at once (rows h·p); only the intra-chunk L×L products go
    head by head."""
    k, g, L, h, p = xdt.shape
    hp = h * p
    cum, w, decay_c, states, hpre = _recompute(xdt, dtf, af, bm, h0)
    hflat = hpre.view(k, g, hp, -1)

    # stage 3, the chunk output. Inter-chunk: y_i += exp(cum_i)·H_{c-1} C_i
    e_cum = torch.exp(cum)
    hc = torch.matmul(cm, hflat.transpose(-1, -2)).view(k, g, L, h, p)
    dcum = (dy * hc).sum(-1) * e_cum                         # (k, g, L, h)
    del hc
    gy = (dy * e_cum[..., None]).reshape(k, g, L, hp)
    dhpre = torch.matmul(gy.transpose(-1, -2), cm).view(k, g, h, p, -1)
    dc = torch.matmul(gy, hflat)                             # (k, g, L, n)
    del gy
    # intra-chunk: y_i += Σ_{j<=i} (C_i·B_j)·exp(cum_i - cum_j)·(x·dt)_j, the
    # masked exponents clamped to 0 before the exp as the reference does
    cum_h = cum.transpose(2, 3)                              # (k, g, h, L)
    rel = cum_h[..., :, None] - cum_h[..., None, :]          # (k, g, h, L, L)
    mask = torch.ones(L, L, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, rel, 0.0)), 0.0)
    del rel
    cb = torch.matmul(cm, bm.transpose(-1, -2))              # (k, g, L, L)
    xdt_h, dy_h = xdt.permute(0, 1, 3, 2, 4), dy.permute(0, 1, 3, 2, 4)
    dm = torch.matmul(dy_h, xdt_h.transpose(-1, -2)).mul_(decay)   # dM ⊙ decay
    dcb = dm.sum(2)                                          # (k, g, L, L)
    drel = dm.mul_(cb[:, :, None])
    dcum += (drel.sum(-1) - drel.sum(-2)).transpose(2, 3)
    del dm, drel
    dxdt_h = torch.matmul(decay.mul_(cb[:, :, None]).transpose(-1, -2), dy_h)   # Mᵀ·dy
    del decay
    dc += torch.matmul(dcb, bm)
    db = torch.matmul(dcb.transpose(-1, -2), cm)
    del dcb, cb

    # stage 2, state passing, in reverse: the chunk states' buffer takes
    # dS_c, the gradient of the state after chunk c
    ds = states
    ds[k - 1] = dh_after
    for c in range(k - 1, 0, -1):
        torch.addcmul(dhpre[c], ds[c], decay_c[c], out=ds[c - 1])
    dh_before = torch.addcmul(dhpre[0], ds[0], decay_c[0])
    del dhpre
    dtotal = torch.matmul(ds.view(k, g, h, 1, -1), hpre.view(k, g, h, -1, 1))[..., 0, 0] \
        * decay_c[..., 0, 0]
    del hpre, hflat

    # stage 1, the chunk states S_c = Σ_j exp(total - cum_j)·(x·dt)_j B_jᵀ
    dsflat = ds.view(k, g, hp, -1)
    sb = torch.matmul(bm, dsflat.transpose(-1, -2)).view(k, g, L, h, p)   # dS_c B_j
    dww = (xdt * sb).sum(-1) * w                             # d(w_j)·w_j
    dxdt = dxdt_h.transpose(2, 3) + sb.mul_(w[..., None])
    del sb, dxdt_h
    db += torch.matmul((xdt * w[..., None]).reshape(k, g, L, hp), dsflat)
    dcum -= dww
    dcum[:, :, -1] += dtotal + dww.sum(2)                    # total = cum at the last position
    return dxdt, dcum, db, dc, dh_before


@torch.no_grad()
def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, dy: torch.Tensor, chunk: int = DEFAULT_CHUNK
                 ) -> tuple[torch.Tensor, ...]:
    """``(dx, ddt, da, dB, dC)`` of :func:`ssd_scan`'s ``y`` for the output
    gradient ``dy`` (b, s, h, p): the closed-form VJP of the chunked scan
    (``ref.ssd_scan_chunked``), in f32 (f64 for f64 inputs, which only the
    tests' gradcheck gives it), each gradient in its input's dtype.
    It takes the scan's three stages in reverse order. Stage 3, the chunk
    output: the masked intra-chunk product ``(C·Bᵀ ⊙ exp(cum_i -
    cum_j)[i >= j])·(x·dt)`` and the carried-state term ``exp(cum) ⊙ (C·
    H_{c-1}ᵀ)``, chunk-parallel. Stage 2, state passing: a reverse scan over
    the chunks, ``dH_{c-1} = exp(total_c)·dH_c + (the output term's share)``,
    with the gradient of ``total_c``. Stage 1, the chunk states ``S_c =
    ((x·dt) ⊙ exp(total - cum))ᵀ·B``, chunk-parallel. Then through ``cum =
    cumsum(dt·a)`` (a reverse cumsum within each chunk) to dt and a.

    It recomputes ``cum`` and the states before each chunk itself, and
    clamps masked exponents before the exp, as the reference does, so no
    ``0·inf`` reaches a gradient. Rows go in groups and one row's chunks in
    segments (:func:`bwd_plan`) so that its working set stays within
    ``WORKSPACE_BYTES``; a row cut into segments first runs its states
    forward to each segment's start, then takes the segments last to
    first. Each position's gradients are written once, rounded from the
    arithmetic's type to the input's. It records no graph: the scan has no
    second derivative."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    L, nc = chunk, s // chunk
    wide = torch.promote_types(x.dtype, torch.float32)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db = torch.empty(bmat.shape, dtype=bmat.dtype, device=x.device)
    dc = torch.empty(cmat.shape, dtype=cmat.dtype, device=x.device)
    da = torch.zeros((h,), dtype=wide, device=x.device)
    af = a.to(wide)
    rows, seg = bwd_plan(b, s, h, p, n, chunk, wide.itemsize)

    def chunked(t: torch.Tensor, r0: int, r1: int, c0: int, c1: int) -> torch.Tensor:
        """Rows r0:r1, chunks c0:c1 of t in the arithmetic's type, as (k, g,
        L, ...) (a view where t has that type)."""
        return t[r0:r1, c0 * L:c1 * L].to(wide).unflatten(1, (c1 - c0, L)).transpose(0, 1)

    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        starts = list(range(0, nc, seg))
        h0 = [torch.zeros((r1 - r0, h, p, n), dtype=wide, device=x.device)]
        for c0 in starts[:-1]:   # each segment's first state
            c1 = c0 + seg
            dts = chunked(dt, r0, r1, c0, c1)
            _, _, decay_c, states, hpre = _recompute(
                chunked(x, r0, r1, c0, c1) * dts[..., None], dts, af,
                chunked(bmat, r0, r1, c0, c1), h0[-1])
            h0.append(torch.addcmul(states[-1], hpre[-1], decay_c[-1]))
            del dts, decay_c, states, hpre
        dh = torch.zeros((r1 - r0, h, p, n), dtype=wide, device=x.device)
        for c0, hstart in zip(reversed(starts), reversed(h0)):
            c1 = min(nc, c0 + seg)
            xs, dts = chunked(x, r0, r1, c0, c1), chunked(dt, r0, r1, c0, c1)
            dxdt, dcum, dbs, dcs, dh = _segment_bwd(
                xs * dts[..., None], dts, af, chunked(bmat, r0, r1, c0, c1),
                chunked(cmat, r0, r1, c0, c1), chunked(dy, r0, r1, c0, c1), hstart, dh)
            dseg = dcum.flip(2).cumsum(2).flip(2)                # d(dt·a), (k, g, L, h)
            pos = (slice(r0, r1), slice(c0 * L, c1 * L))
            dx[pos] = (dxdt * dts[..., None]).transpose(0, 1).flatten(1, 2)
            ddt[pos] = (dseg * af + (dxdt * xs).sum(-1)).transpose(0, 1).flatten(1, 2)
            da += (dseg * dts).sum((0, 1, 2))
            db[pos] = dbs.transpose(0, 1).flatten(1, 2)
            dc[pos] = dcs.transpose(0, 1).flatten(1, 2)
            del dxdt, dcum, dseg, dbs, dcs, xs, dts
    return dx, ddt, da.to(a.dtype), db, dc


class SSDScan(torch.autograd.Function):
    """:func:`ssd_scan` with :func:`ssd_scan_bwd` as its gradient. The
    forward is one launch of the kernels on the card (the plain version on
    the CPU) and gives ``(y, h_final)``; the final state takes no gradient.
    It saves the inputs; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk: int):
        y, h_final = _scan(x, dt, a, bmat, cmat, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(h_final)
        return y, h_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dh_final):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, ctx.chunk), None)
