"""Plain PyTorch versions of the model kernels: the semantics of record.

The counterpart of ``repro.kernels.ref``. On a CPU tensor the kernel
wrappers (``kernels/rmsnorm.py``, ``kernels/flash_attention.py``) run these;
on the card ``chip_smoke.py`` and the card-only tests hold each kernel
against them. ``attention`` is also the model's attention over a KV cache,
which the JAX package computes outside Pallas too. Every one computes in f32
and returns the input's type, as the reference does. ``attention_bwd`` is
the flash-attention backward's function; RMSNorm's gradient has no kernel
(``kernels/rmsnorm.py:rmsnorm_bwd``). ``ssd_scan_chunked`` is the SSD
chunked scan's function (``kernels/ssd_scan.py``), composed of its three
stages as the kernels split it, and ``ssd_scan_sequential`` the exact
recurrence it is held against.
"""
from __future__ import annotations

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float | None) -> torch.Tensor:
    """f32 ``q·kᵀ·scale`` as (b, hkv, group, sq, sk): q head h meets kv head
    h // group, with no repeated k."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv != 0:
        raise ValueError(f"{hq} query heads do not divide into {hkv} kv heads")
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    return torch.einsum("bkgqd,bkTd->bkgqT", qg, k.float()) * scale


def attention(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, sk, d)
    v: torch.Tensor,  # (b, hkv, sk, d)
    causal: bool = True,
    scale: float | None = None,
    kv_len: torch.Tensor | None = None,  # (b,) valid kv length (decode masking)
    q_offset: int = 0,                   # absolute position of q[0] (decode)
) -> torch.Tensor:
    """GQA attention without materialising repeated k/v (``ref.py:17``):
    causal keeps ``col <= row + q_offset``; ``kv_len`` masks each batch
    row's columns from its length on."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    s = _scores(q, k, scale)
    col = torch.arange(sk, device=q.device)
    if causal:
        row = torch.arange(sq, device=q.device) + q_offset
        s = s.masked_fill(col[None, :] > row[:, None], float("-inf"))
    if kv_len is not None:
        invalid = col[None, :] >= kv_len.to(q.device)[:, None]
        s = s.masked_fill(invalid[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqT,bkTd->bkgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, scale: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash-attention forward's function (``flash_attention.py:106``):
    ``o`` in q's type and the f32 log-sum-exp ``lse`` (b, hq, sq). Causal
    keeps ``col <= row`` counted from the top left, also when sq != sk. A
    row with no unmasked column gets ``o = 0`` and ``lse = +inf`` (where
    ``torch.logsumexp`` gives -inf)."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    s = _scores(q, k, scale)
    if causal:
        col = torch.arange(sk, device=q.device)
        row = torch.arange(sq, device=q.device)
        s = s.masked_fill(col[None, :] > row[:, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    empty = torch.isneginf(lse)
    p = torch.exp(s - lse.masked_fill(empty, 0.0)[..., None])
    out = torch.einsum("bkgqT,bkTd->bkgqd", p, v.float())
    lse = lse.masked_fill(empty, float("inf"))
    return out.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash-attention backward's function (``flash_attention_bwd``,
    ``flash_attention.py:258``, with the wrapper's group sum at :343-356):
    ``dq`` (b, hq, sq, d), ``dk`` and ``dv`` (b, hkv, sk, d), each in its
    input's type, from the forward's ``o`` and f32 ``lse``. In f32:
    ``p = exp(s·scale - lse)`` (0 where masked, and on a row with
    ``lse = +inf``), ``δ = rowsum(do ⊙ o)``, ``ds = p ⊙ (do·vᵀ - δ)·scale``,
    ``dq = ds·k``, ``dk = dsᵀ·q`` and ``dv = pᵀ·do``, the last two summed over
    each kv head's query heads with no repeated k/v."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    p = _scores(q, k, scale)                          # (b, hkv, g, sq, sk)
    p.sub_(lse.reshape(b, hkv, g, sq, 1)).exp_()
    if causal:
        col = torch.arange(sk, device=q.device)
        row = torch.arange(sq, device=q.device)
        p.masked_fill_(col[None, :] > row[:, None], 0.0)
    dof = do.reshape(b, hkv, g, sq, d).float()
    delta = (dof * o.reshape(b, hkv, g, sq, d).float()).sum(-1, keepdim=True)
    ds = torch.einsum("bkgqd,bkTd->bkgqT", dof, v.float())
    ds.sub_(delta).mul_(p).mul_(scale)
    dq = torch.einsum("bkgqT,bkTd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqT,bkgqd->bkTd", ds, q.reshape(b, hkv, g, sq, d).float())
    dv = torch.einsum("bkgqT,bkgqd->bkTd", p, dof)
    return dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(x [+ residual]) * rsqrt(mean((x [+ residual])²) + eps) * w`` in
    f32, returned in x's type (``ref.py:165``)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality): sequential oracle and chunked closed form
# ---------------------------------------------------------------------------

def ssd_scan_sequential(
    x: torch.Tensor,     # (b, s, h, p) per-head inputs
    dt: torch.Tensor,    # (b, s, h)    softplus'd timestep
    a: torch.Tensor,     # (h,)         negative decay rate per head
    bmat: torch.Tensor,  # (b, s, n)    input projection, shared by the heads
    cmat: torch.Tensor,  # (b, s, n)    output projection
) -> torch.Tensor:
    """The exact recurrence ``h_t = exp(dt_t·a)·h_{t-1} + dt_t·x_t B_tᵀ``,
    ``y_t = h_t C_t`` (``ref.py:75``), one step per position, in f32;
    returns x's type."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])                      # (b, h)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], bf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_final_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor) -> torch.Tensor:
    """The state after a prefix consumed from an empty state in closed form
    over the whole prefix, the reference's ``_ssm_state_after_prefill``
    (``layers.py:491``): ``Σ_t exp(total - cum_t)·(x·dt)_t B_tᵀ`` (b, h, p,
    n), with ``cum`` the cumsum of ``dt·a`` over the prefix. Computed in f64
    and returned in f32: in f32 a whole-prefix cumsum loses the exponent's
    low bits at long prefixes (cum reaches about -3000 at 32768 positions,
    where an f32 ulp is 2.4e-4)."""
    dtf = dt.double()
    cum = torch.cumsum(dtf * a.double(), dim=1)             # (b, s, h)
    w = torch.exp(cum[:, -1:, :] - cum)
    xdt = x.double() * dtf[..., None]                       # (b, s, h, p)
    return torch.einsum("bshp,bsn->bhpn", xdt * w[..., None], bmat.double()).float()


def ssd_chunk_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the chunked SSD (kernel 1 of ``csrc/ssd_scan.cu``):
    ``cum`` (b, nc, L, h), the inclusive cumsum of ``dt·a`` within each
    chunk, and the chunk states ``S_c = Σ_j exp(total - cum_j)·(x·dt)_j
    B_jᵀ`` (b, nc, h, p, n), in f32."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence {s} does not divide into chunks of {chunk}")
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = bmat.float().reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtf * a.float(), dim=2)             # (b, nc, L, h)
    total = cum[:, :, -1, :]                                # (b, nc, h)
    cum_h = cum.permute(0, 1, 3, 2)                         # (b, nc, h, L)
    xdt_h = (xf * dtf[..., None]).permute(0, 1, 3, 2, 4)    # (b, nc, h, L, p)
    w = torch.exp(total[:, :, :, None] - cum_h)             # (b, nc, h, L)
    state = torch.matmul((xdt_h * w[..., None]).transpose(-1, -2), bf[:, :, None])
    return cum, state


def ssd_state_passing(state: torch.Tensor, total: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 (kernel 2): from the chunk states (b, nc, h, p, n) and each
    chunk's ``total`` (b, nc, h), the state before each chunk, ``H_{c-1}``
    (zero before the first), and the state after the last,
    ``H_c = exp(total_c)·H_{c-1} + S_c``, in f32."""
    bsz, nc, h, p, n = state.shape
    hstate = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=state.device)
    hpre = torch.empty_like(state)
    for c in range(nc):
        hpre[:, c] = hstate
        hstate = hstate * torch.exp(total[:, c])[..., None, None] + state[:, c]
    return hpre, hstate


def ssd_chunk_output(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                     cmat: torch.Tensor, cum: torch.Tensor, hpre: torch.Tensor
                     ) -> torch.Tensor:
    """Stage 3 (kernel 3): ``y`` (b, s, h, p) in f32, the intra-chunk term
    ``(C·Bᵀ ⊙ exp(cum_i - cum_j)[i >= j])·(x·dt)`` plus the inter-chunk
    term ``(C ⊙ exp(cum))·H_{c-1}ᵀ``. The intra-chunk product contracts j
    with a batched matmul per head, so no (b, nc, L, L, h, p) tensor is
    formed."""
    bsz, s, h, p = x.shape
    nc, chunk = cum.shape[1], cum.shape[2]
    n = bmat.shape[-1]
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = bmat.float().reshape(bsz, nc, chunk, n)
    cf = cmat.float().reshape(bsz, nc, chunk, n)
    cum_h = cum.permute(0, 1, 3, 2)                         # (b, nc, h, L)
    # masked exponents clamped to 0 before the exp (they can overflow to
    # inf), as ref.py:132-134
    rel = cum_h[..., :, None] - cum_h[..., None, :]         # (b, nc, h, L, L)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, rel, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)            # (b, nc, L, L)
    xdt_h = (xf * dtf[..., None]).permute(0, 1, 3, 2, 4)    # (b, nc, h, L, p)
    y_intra = torch.matmul(cb[:, :, None] * decay, xdt_h)   # (b, nc, h, L, p)
    # y_inter[i] = exp(cum_i)·Σ_n C[i, n]·H[p, n]
    y_inter = torch.matmul(cf[:, :, None], hpre.transpose(-1, -2)) * torch.exp(cum_h)[..., None]
    return (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 64,
                     return_state: bool = False
                     ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD (``ref.py:111``), the function the SSD scan kernels
    compute, in f32; returns ``y`` in x's type, and with ``return_state``
    also the f32 state after the last chunk (b, h, p, n). It composes the
    three stages: :func:`ssd_chunk_state`, :func:`ssd_state_passing` and
    :func:`ssd_chunk_output`."""
    cum, state = ssd_chunk_state(x, dt, a, bmat, chunk)
    hpre, h_final = ssd_state_passing(state, cum[:, :, -1, :])
    y = ssd_chunk_output(x, dt, bmat, cmat, cum, hpre).to(x.dtype)
    return (y, h_final) if return_state else y
