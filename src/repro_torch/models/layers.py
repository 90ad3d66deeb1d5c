"""Layer library of the decoder LM on PyTorch: GQA attention (RoPE, KV
cache, head padding), GLU/GeGLU MLPs, the token-choice MoE and the Mamba-2
(SSD) block, the counterpart of ``repro.models.layers``.

Parameters are kept as the JAX package keeps them, for ``x @ w``: a
projection weight is ``(in, out)``. Projections, the MLP and the MoE's
routing, dispatch and expert products are plain torch ops, as the JAX
package leaves them to XLA (no Pallas kernel there); attention without a
cache, the SSD scan of a prefill or a cache-less forward, and RMSNorm go
through ``repro_torch.kernels.ops`` (hand-written kernels on the card); the
Mamba-2 decode step is the plain recurrence, as in the JAX package.
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
    write_cache: bool = False,
):
    """The mixer's output (b, s, d). With a cache and ``cache_pos``, k/v
    are written into the cache in place at ``cache_pos`` and q attends over
    it (plain ``ref.attention``, masked by the filled length), as
    ``layers.py:104-120``; without one, q attends over its own k/v through
    the flash-attention forward (causal). With ``write_cache`` it returns
    ``(output, cache)`` as the reference does: the cache written in place,
    or on the cache-less path the post-RoPE ``{"k", "v"}`` (b, kv, s, hd)."""
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
        if write_cache:
            cache = {"k": k, "v": v}
    out = out.transpose(1, 2).reshape(b, s, hp * hd) @ p.wo
    return (out, cache) if write_cache else out


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


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> MLP:
    """A SwiGLU / GeGLU MLP of width ``d_ff`` (default ``cfg.d_ff``)."""
    dt = torch_dtype(cfg)
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    wi = normal(gen, (d, 2 * ff), 1.0 / math.sqrt(d), dt)
    wo = normal(gen, (ff, d), 1.0 / math.sqrt(ff), dt)
    return MLP(wi, wo)


def _glu(kind: str, h: torch.Tensor) -> torch.Tensor:
    gate, up = h.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(gate, approximate="tanh") if kind == "geglu" else F.silu(gate)
    return act * up


def mlp_forward(kind: str, p: MLP, x: torch.Tensor) -> torch.Tensor:
    return _glu(kind, x @ p.wi) @ p.wo


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, gather/scatter dispatch with capacity dropping)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """One MoE feed-forward: ``router`` (d, E_pad) f32, ``w_in`` (E_pad, d,
    2·ffe) (each expert's fused gate|up), ``w_out`` (E_pad, ffe, d); the
    always-on ``shared`` MLP (width ``moe_shared_experts · moe_d_ff``) and
    the ``dense`` residual MLP (width ``d_ff``, arctic), each or ``None``."""

    def __init__(self, router: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                 shared: MLP | None = None, dense: MLP | None = None):
        super().__init__()
        self.router, self.w_in, self.w_out = weight(router), weight(w_in), weight(w_out)
        self.shared = shared
        self.dense = dense


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> MoE:
    """An MoE layer at the JAX package's scales (``layers.py:166``): the
    router and each expert's projections scaled by 1/sqrt(fan-in), the
    experts ``pad_experts_to`` adds zero (the router masks them)."""
    dt = torch_dtype(cfg)
    d, e, ffe = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    ep = cfg.moe_experts_padded
    router = normal(gen, (d, ep), 1.0 / math.sqrt(d), torch.float32)
    w_in = normal(gen, (ep, d, 2 * ffe), 1.0 / math.sqrt(d), dt)
    w_out = normal(gen, (ep, ffe, d), 1.0 / math.sqrt(ffe), dt)
    w_in[e:] = 0
    w_out[e:] = 0
    shared = (init_mlp(cfg, gen, cfg.moe_shared_experts * ffe)
              if cfg.moe_shared_experts else None)
    dense = init_mlp(cfg, gen, cfg.d_ff) if cfg.moe_dense_residual else None
    return MoE(router, w_in, w_out, shared, dense)


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a call on ``tokens`` tokens: ``ceil(T·k·factor /
    E_pad)``, at least 1 (a decode step of 4 tokens has 1 and drops)."""
    return max(int(math.ceil(tokens * cfg.moe_top_k * cfg.moe_capacity_factor
                             / cfg.moe_experts_padded)), 1)


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, mlp_kind: str = "glu",
                stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, aux)``: the MoE layer on x (b, s, d) and its Switch-style
    load-balancing loss ``E · Σ_e mean(probs_e) · mean(count_e)``, the
    gather path of ``layers.py:200`` (``moe_impl == "shard_map_ep"`` takes
    it too: expert parallelism comes with sharding).

    Each token goes to its top-k experts by router probability (f32, padded
    experts masked with -1e9), weighted by the renormalised top-k
    probabilities. The T·k (token, expert) pairs are sorted stably by expert
    and each takes the next slot of its expert's ``moe_capacity`` slots; a
    pair past them goes to the drop bin (slot ``cap``) with weight 0. The
    experts run as two batched products over the (E, cap + 1, d) buffer.
    Each token sums its k weighted outputs in f32 in ascending expert
    order, the order of the reference's sorted scatter-add (no atomics: the
    same sum on every run), casts to x's type and adds the shared and the
    dense MLPs. With ``stats``, adds the pairs dropped under ``"dropped"``
    and the pairs routed under ``"routed"`` (a host sync each)."""
    b, s, d = x.shape
    e, k = cfg.moe_experts_padded, cfg.moe_top_k
    t = b * s
    xf = x.reshape(t, d)
    logits = xf.float() @ p.router                            # (T, E_pad)
    if e > cfg.moe_experts:
        logits = logits.masked_fill(
            torch.arange(e, device=x.device) >= cfg.moe_experts, -1e9)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                 # (T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)

    cap = moe_capacity(cfg, t)
    flat_e = topi.reshape(-1)                                 # (T·k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - starts[sorted_e]
    token_of = order // k
    valid = pos < cap
    dest_c = torch.where(valid, pos, cap)                     # cap: the drop bin
    if stats is not None:
        dropped = int((~valid).sum())
        stats["dropped"] = stats.get("dropped", 0) + dropped
        stats["routed"] = stats.get("routed", 0) + t * k

    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[sorted_e, dest_c] = xf[token_of]      # only the drop bin takes two writes
    hout = torch.bmm(_glu(mlp_kind, torch.bmm(buf, p.w_in)), p.w_out)  # (E, cap+1, d)

    # back to (token, slot) order, then each token's k slots by expert
    contrib = torch.empty((t * k, d), dtype=torch.float32, device=x.device)
    contrib[order] = hout[sorted_e, dest_c].float() * (
        topw.reshape(-1)[order] * valid)[:, None]
    contrib = contrib.view(t, k, d)
    by_expert = torch.argsort(topi, dim=-1, stable=True)      # k distinct experts
    rows = torch.arange(t, device=x.device)
    y = contrib[rows, by_expert[:, 0]]
    for j in range(1, k):
        y = y + contrib[rows, by_expert[:, j]]
    y = y.to(x.dtype)
    if p.shared is not None:
        y = y + mlp_forward(mlp_kind, p.shared, xf)
    if p.dense is not None:
        y = y + mlp_forward(mlp_kind, p.dense, xf)

    me = probs.mean(dim=0)
    ce = F.one_hot(topi, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

SSM_NAMES = ("w_z", "w_x", "w_bc", "w_dt", "conv_x_w", "conv_x_b", "conv_bc_w",
             "conv_bc_b", "a_log", "d_skip", "dt_bias", "norm_w", "out_proj")


class SSM(nn.Module):
    """The 13 tensors of one Mamba-2 mixer (``init_ssm``), under the JAX
    package's names: the projections w_z, w_x (d, d_inner), w_bc (d, 2n),
    w_dt (d, h); the depthwise conv kernels (k, d_inner) and (k, 2n) and
    their biases; a_log, d_skip and dt_bias (h,) in f32; the gated norm's
    norm_w (d_inner,); out_proj (d_inner, d)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(SSM_NAMES):
            raise ValueError(f"SSM takes exactly {SSM_NAMES}, got {sorted(tensors)}")
        for name in SSM_NAMES:
            setattr(self, name, weight(tensors[name]))


def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> SSM:
    """A Mamba-2 mixer at the JAX package's scales (``layers.py:371``):
    separate projections (w_z | w_x | w_bc | w_dt) scaled by 1/sqrt(d), conv
    kernels by 0.5 with zero biases, ``a_log = log(linspace(1, 8, h))``
    (A = -exp(a_log)), unit d_skip and norm, zero dt_bias."""
    dt, dev = torch_dtype(cfg), gen.device
    d = cfg.d_model
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    sc = 1.0 / math.sqrt(d)
    return SSM(
        w_z=normal(gen, (d, di), sc, dt),
        w_x=normal(gen, (d, di), sc, dt),
        w_bc=normal(gen, (d, 2 * n), sc, dt),
        w_dt=normal(gen, (d, h), sc, dt),
        conv_x_w=normal(gen, (cfg.ssm_conv_kernel, di), 0.5, dt),
        conv_x_b=torch.zeros(di, dtype=dt, device=dev),
        conv_bc_w=normal(gen, (cfg.ssm_conv_kernel, 2 * n), 0.5, dt),
        conv_bc_b=torch.zeros(2 * n, dtype=dt, device=dev),
        a_log=torch.log(torch.linspace(1.0, 8.0, h, dtype=torch.float32, device=dev)),
        d_skip=torch.ones(h, dtype=torch.float32, device=dev),
        dt_bias=torch.zeros(h, dtype=torch.float32, device=dev),
        norm_w=torch.ones(di, dtype=dt, device=dev),
        out_proj=normal(gen, (di, d), 1.0 / math.sqrt(di), dt),
    )


def _causal_depthwise_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """xbc (b, s, ch), w (k, ch): the depthwise causal conv along s, summed
    in f32 over the k shifted slices of the zero-padded input in order, plus
    the bias, in xbc's type (``layers.py:403``)."""
    ksz, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, ksz - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(ksz):
        out = out + pad[:, i:i + s, :].float() * w[i][None, None, :].float()
    return (out + b[None, None, :].float()).to(xbc.dtype)


def make_ssm_cache(cfg: ModelConfig, batch: int, device: torch.device,
                   dtype: torch.dtype | None = None) -> dict:
    """A zeroed Mamba-2 decode state: the last k - 1 inputs of each conv
    (``conv_x`` (batch, k-1, d_inner), ``conv_bc`` (batch, k-1, 2n)) and the
    f32 SSD state ``ssm`` (batch, h, head_dim, n); the convs' inputs in
    ``dtype`` (default the model dtype)."""
    dt = dtype or torch_dtype(cfg)
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    k1 = cfg.ssm_conv_kernel - 1
    return {
        "conv_x": torch.zeros((batch, k1, di), dtype=dt, device=device),
        "conv_bc": torch.zeros((batch, k1, 2 * n), dtype=dt, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def ssm_forward(
    cfg: ModelConfig,
    p: SSM,
    x: torch.Tensor,              # (b, s, d)
    cache: dict | None = None,    # {"conv_x", "conv_bc", "ssm"}
) -> tuple[torch.Tensor, dict | None]:
    """The Mamba-2 mixer's output (b, s, d) and its new decode state
    (``layers.py:419``; ``None`` without a cache). With a cache and s == 1,
    one step of the recurrence in f32 from the cached conv inputs and SSD
    state; otherwise the causal convs and the SSD scan (``ops.ssd_scan``:
    the kernels on the card) over the whole sequence from an empty state,
    and, with a cache, the state after it, which the scan returns
    (:func:`_ssm_state_after_prefill`).
    The casts are the reference's: a prefill's dt in the model's type
    before the scan, a decode step's in f32; d_skip·x added in f32 and cast;
    the gate ``y ⊙ silu(z)`` in the model's type before the RMSNorm over
    d_inner."""
    b, s, _ = x.shape
    di, n, h, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p.w_z                                             # (b, s, di)
    xr = x @ p.w_x                                            # (b, s, di)
    bc = x @ p.w_bc                                           # (b, s, 2n)
    dt_raw = x @ p.w_dt                                       # (b, s, h)
    a = -torch.exp(p.a_log)                                   # (h,)

    new_cache = cache
    if cache is not None and s == 1:
        # decode: one recurrence step
        hist_x = torch.cat([cache["conv_x"], xr], dim=1)      # (b, k, di)
        hist_bc = torch.cat([cache["conv_bc"], bc], dim=1)
        cx = torch.einsum("bkc,kc->bc", hist_x.float(), p.conv_x_w.float()) \
            + p.conv_x_b.float()
        cbc = torch.einsum("bkc,kc->bc", hist_bc.float(), p.conv_bc_w.float()) \
            + p.conv_bc_b.float()
        cx, cbc = F.silu(cx), F.silu(cbc)
        xt = cx.reshape(b, h, hd)                             # (b, h, hd)
        bmat, cmat = cbc[:, :n], cbc[:, n:]
        dtv = F.softplus(dt_raw[:, 0].float() + p.dt_bias)    # (b, h) f32
        decay = torch.exp(dtv * a[None, :])                   # (b, h)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtv[..., None], bmat)
        hstate = cache["ssm"] * decay[..., None, None] + upd
        yt = torch.einsum("bhpn,bn->bhp", hstate, cmat)
        yt = yt + p.d_skip[None, :, None] * xt
        y = yt.reshape(b, 1, di).to(x.dtype)
        new_cache = {"conv_x": hist_x[:, 1:], "conv_bc": hist_bc[:, 1:], "ssm": hstate}
    else:
        cx = F.silu(_causal_depthwise_conv(xr, p.conv_x_w, p.conv_x_b).float()).to(x.dtype)
        cbc = F.silu(_causal_depthwise_conv(bc, p.conv_bc_w, p.conv_bc_b).float()).to(x.dtype)
        xin = cx.reshape(b, s, h, hd)
        bmat, cmat = cbc[..., :n], cbc[..., n:]               # strided views
        dtv = F.softplus(dt_raw.float() + p.dt_bias).to(x.dtype)
        if cache is None:
            y = ops.ssd_scan(xin, dtv, a, bmat, cmat)
        else:
            y, hstate = ops.ssd_scan(xin, dtv, a, bmat, cmat, return_state=True)
            new_cache = _ssm_state_after_prefill(cfg, xr, bc, hstate)
        y = y + (p.d_skip[None, None, :, None] * xin.float()).to(x.dtype)
        y = y.reshape(b, s, di)

    y = ops.rmsnorm(y * F.silu(z.float()).to(x.dtype), p.norm_w, eps=cfg.norm_eps)
    return y @ p.out_proj, new_cache


def _ssm_state_after_prefill(cfg: ModelConfig, xr: torch.Tensor, bc: torch.Tensor,
                             hstate: torch.Tensor) -> dict:
    """The decode state after a prefix consumed from an empty state
    (``layers.py:491``): the last k - 1 conv inputs (zero-padded on the
    left when the prefix is shorter) and the scan's f32 state after the
    last chunk. That state is the reference's ``Σ_t exp(total - cum_t)·
    (x·dt)_t B_tᵀ`` over the whole prefix, summed chunk by chunk."""
    s = xr.shape[1]
    k1 = cfg.ssm_conv_kernel - 1

    def tail(arr: torch.Tensor) -> torch.Tensor:
        if s >= k1:  # a copy: a view would keep the whole prefix's projection alive
            return arr[:, s - k1:, :].clone()
        return F.pad(arr, (0, 0, k1 - s, 0))

    return {"conv_x": tail(xr), "conv_bc": tail(bc), "ssm": hstate}
