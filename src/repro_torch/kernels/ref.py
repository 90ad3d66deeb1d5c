"""Plain PyTorch versions of the model kernels: the semantics of record.

The counterpart of ``repro.kernels.ref``. On a CPU tensor the kernel
wrappers (``kernels/rmsnorm.py``, ``kernels/flash_attention.py``) run these;
on the card ``chip_smoke.py`` and the card-only tests hold each kernel
against them. ``attention`` is also the model's attention over a KV cache,
which the JAX package computes outside Pallas too. Every one computes in f32
and returns the input's type, as the reference does. ``attention_bwd`` is
the flash-attention backward's function; RMSNorm's gradient has no kernel
(``kernels/rmsnorm.py:rmsnorm_bwd``). ``ssd_scan_*`` comes with the Mamba-2
slice.
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
