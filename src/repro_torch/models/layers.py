"""Layer library of the decoder LM on PyTorch: GQA attention (RoPE, KV
cache, head padding) and GLU/GeGLU MLPs, the counterpart of
``repro.models.layers``.

Parameters are kept as the JAX package keeps them, for ``x @ w``: a
projection weight is ``(in, out)``. Projections and the MLP are plain
products, as the JAX package leaves them to XLA; attention without a cache
and RMSNorm go through ``repro_torch.kernels.ops`` (hand-written kernels on
the card). MoE and Mamba-2 (SSD) layers come with later slices of the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels import ref as kref


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def weight(t: torch.Tensor) -> nn.Parameter:
    """A serving weight: a parameter that takes no gradient."""
    return nn.Parameter(t, requires_grad=False)


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, scale²) drawn in f32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, h, s, d), positions: (s,) or (b, s); rotation in f32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = (positions[:, None].float() * freqs[None, :])[None, None]  # (1, 1, s, half)
    else:
        ang = (positions[..., None].float() * freqs)[:, None]            # (b, 1, s, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional head padding, KV cache)
# ---------------------------------------------------------------------------

def head_pad_mask(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Bool (n_heads_padded,): which padded q-head slots are real. Padding is
    per kv group (q heads are laid out kv-major), as ``layers.py:57``."""
    hp, kv = cfg.n_heads_padded, cfg.n_kv_heads
    if hp == cfg.n_heads:
        return torch.ones(hp, dtype=torch.bool, device=device)
    if cfg.n_heads % kv or hp % kv:
        raise ValueError(f"heads {cfg.n_heads} / padded {hp} do not divide by kv {kv}")
    return torch.arange(hp, device=device) % (hp // kv) < cfg.n_heads // kv


class Attention(nn.Module):
    """Projections of one attention mixer: wq (d, hp·hd), wk and wv
    (d, kv·hd), wo (hp·hd, d)."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (weight(t) for t in (wq, wk, wv, wo))


def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Attention:
    dt = torch_dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim_
    hp, kv = cfg.n_heads_padded, cfg.n_kv_heads
    sc = 1.0 / math.sqrt(d)
    wq = normal(gen, (d, hp * hd), sc, dt)
    wk = normal(gen, (d, kv * hd), sc, dt)
    wv = normal(gen, (d, kv * hd), sc, dt)
    wo = normal(gen, (hp * hd, d), 1.0 / math.sqrt(hp * hd), dt)
    if hp > cfg.n_heads:  # zero the padded head slices: exact no-ops
        mask = head_pad_mask(cfg, gen.device).repeat_interleave(hd).to(dt)
        wq = wq * mask[None, :]
        wo = wo * mask[:, None]
    return Attention(wq, wk, wv, wo)


def attention_forward(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,                 # (b, s, d)
    positions: torch.Tensor,         # (s,)
    cache: dict | None = None,       # {"k", "v"}: (b, kv, S, hd)
    cache_pos: int | None = None,
):
    """The mixer's output (b, s, d). With a cache and ``cache_pos``, k/v
    are written into the cache in place at ``cache_pos`` and q attends over
    it (plain ``ref.attention``, masked by the filled length), as
    ``layers.py:104-120``; without one, q attends over its own k/v through
    the flash-attention forward (causal)."""
    b, s, _ = x.shape
    hp, kv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p.wq).reshape(b, s, hp, hd).transpose(1, 2)
    k = (x @ p.wk).reshape(b, s, kv, hd).transpose(1, 2)
    v = (x @ p.wv).reshape(b, s, kv, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and cache_pos is not None:
        ck, cv = cache["k"], cache["v"]
        if cache_pos + s > ck.shape[2]:
            raise ValueError(f"cache of length {ck.shape[2]} cannot take positions "
                             f"{cache_pos}..{cache_pos + s - 1}")
        ck[:, :, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, :, cache_pos:cache_pos + s] = v.to(cv.dtype)
        kv_len = torch.full((b,), cache_pos + s, dtype=torch.int32, device=x.device)
        out = kref.attention(q, ck, cv, causal=s > 1, kv_len=kv_len, q_offset=cache_pos)
    else:
        out = ops.flash_attention(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(b, s, hp * hd)
    return out @ p.wo


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, dtype: torch.dtype | None = None) -> dict:
    dt = dtype or torch_dtype(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """wi (d, 2·ff): the fused gate|up projection; wo (ff, d)."""

    def __init__(self, wi: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wi, self.wo = weight(wi), weight(wo)


def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> MLP:
    dt = torch_dtype(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    wi = normal(gen, (d, 2 * ff), 1.0 / math.sqrt(d), dt)
    wo = normal(gen, (ff, d), 1.0 / math.sqrt(ff), dt)
    return MLP(wi, wo)


def mlp_forward(kind: str, p: MLP, x: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ p.wi).chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(gate, approximate="tanh") if kind == "geglu" else F.silu(gate)
    return (act * up) @ p.wo
