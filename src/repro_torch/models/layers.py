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

**On a mesh** (``sharding.context``): with a mesh set, attention, the dense
MLP and the MoE run on the rank's local shards (``sharding.layout``) and
call ``sharding.collectives``: Megatron's column-parallel products behind
``copy_to`` (identity forward, the gradient summed over ``model``) and
row-parallel ones followed by ``reduce_from`` (the sum over ``model``,
the gradient passed through); an FSDP weight (its free dimension shorter
than the whole, ``cfg.fsdp_params``) is gathered over the data axes before
use by ``gather_from``, whose backward reduce-scatters its gradient.
Gradients that come out of a layer are therefore whole over ``model`` and
partial over the data axes: the train step sums those of the weights not
FSDP-gathered. The Mamba-2 mixer splits its SSD heads over ``model``
(:func:`ssm_forward`): column-parallel w_z / w_x and the x conv, the scan
on the local heads, a gated norm over the gathered d_inner, row-parallel
out_proj.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels import ref as kref
from ..sharding import collectives as C
from ..sharding import strategy as S
from ..sharding.context import get_mesh


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
    or on the cache-less path the post-RoPE ``{"k", "v"}`` (b, kv, s, hd).
    On a mesh the same body runs on the rank's shards
    (:func:`_attention_shards`) and wo's product is row-parallel; on the
    card the local heads go through the flash kernel as the whole model's
    do."""
    b, s, _ = x.shape
    hd, mesh = cfg.head_dim_, get_mesh()
    x, (wq, wk, wv, wo), read = _attention_shards(cfg, p, x, mesh)
    q = (x @ wq).reshape(b, s, -1, hd).transpose(1, 2)
    k = (x @ wk).reshape(b, s, -1, hd).transpose(1, 2)
    v = (x @ wv).reshape(b, s, -1, hd).transpose(1, 2)
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
        out = kref.attention(q, ck[:, read], cv[:, read], causal=s > 1, kv_len=kv_len,
                             q_offset=cache_pos)
    else:
        out = ops.flash_attention(q, k[:, read], v[:, read], causal=True)
        if write_cache:
            cache = {"k": k, "v": v}
    out = out.transpose(1, 2).reshape(b, s, -1)
    out = out @ wo if mesh is None else row_parallel(out, wo, mesh)
    return (out, cache) if write_cache else out


def _attention_shards(cfg: ModelConfig, p: Attention, x: torch.Tensor, mesh):
    """``(x, (wq, wk, wv, wo), read)``: the input and weights
    :func:`attention_forward` runs on and the kv heads its q heads read.
    Without a mesh, x, the whole weights and every kv head. On a mesh, the
    rank's ``hp/tp`` q heads (column-parallel wq, x entering through
    ``copy_to``); k/v column-parallel when the kv heads split over
    ``model``, else whole on every rank (the cache too), each rank reading
    the kv heads its q heads read (:func:`kv_heads_read`); FSDP weights
    gathered (:func:`whole`)."""
    if mesh is None:
        return x, (p.wq, p.wk, p.wv, p.wo), slice(None)
    d, hp, tp = x.shape[-1], cfg.n_heads_padded, mesh.axis_size("model")
    if hp % tp:
        raise ValueError(f"{cfg.name}: {hp} heads do not split {tp} ways")
    wq, wk, wv = (whole(w, 0, d, mesh) for w in (p.wq, p.wk, p.wv))
    read = slice(None)
    if not S.kv_shardable(cfg, mesh):
        # whole k/v on every rank, each reading part: sum their gradients
        wk, wv = C.copy_to(wk, "model", mesh), C.copy_to(wv, "model", mesh)
        first, count = kv_heads_read(cfg, mesh)
        read = slice(first, first + count)
    return C.copy_to(x, "model", mesh), (wq, wk, wv, whole(p.wo, 1, d, mesh)), read


def whole(w: torch.Tensor, dim: int, size: int, mesh) -> torch.Tensor:
    """A weight as a layer on a mesh uses it: dimension ``dim`` gathered over
    the data axes to ``size`` where FSDP split it (``gather_from``), else w."""
    if w.shape[dim] == size:
        return w
    dp = S.dp_axes(mesh)
    if w.shape[dim] * mesh.axis_size(dp) != size:
        raise ValueError(f"a weight of shape {tuple(w.shape)} is no shard of size {size} "
                         f"along dim {dim} on {mesh}")
    return C.gather_from(w, dp, dim, mesh)


def local_rows(batch: int, mesh) -> int:
    """A data rank's rows of a global batch (``strategy.batch_specs``)."""
    dp = mesh.axis_size(S.dp_axes(mesh))
    if batch % dp:
        raise ValueError(f"a batch of {batch} does not split over {dp} data ranks")
    return batch // dp


def row_parallel(a: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``a @ w`` where each ``model`` rank holds a slice of the contracted
    dimension: the partial products in f32, summed over ``model``, rounded
    once to a's type. A bf16 product rounded before the sum would round
    every element twice where the whole model's product rounds it once."""
    return C.reduce_from(a.float() @ w.float(), "model", mesh).to(a.dtype)


def kv_heads_read(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """``(first, count)``: the kv heads this model rank's q heads read when
    k/v are replicated (``n_kv_heads % tp != 0``). q heads are laid out
    kv-major, ``n_heads_padded / n_kv_heads`` to a kv head, and rank r holds
    q heads ``[r·hp/tp, (r+1)·hp/tp)``; the local q heads must map onto the
    local kv heads as a GQA call maps them (one kv head to a run of q heads
    of equal length)."""
    tp, hp, kv = mesh.axis_size("model"), cfg.n_heads_padded, cfg.n_kv_heads
    hl, group = hp // tp, hp // kv
    if hl % group and group % hl:
        raise ValueError(f"{cfg.name}: {hl} q heads a rank do not align with kv groups "
                         f"of {group}")
    first = mesh.axis_index("model") * hl // group
    return first, max(hl // group, 1)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, dtype: torch.dtype | None = None) -> dict:
    """A zeroed kv cache (batch, kv, max_len, hd); on a mesh, this rank's
    shard under ``strategy.cache_specs`` (batch over the data axes, kv
    heads over ``model`` when they divide)."""
    dt = dtype or torch_dtype(cfg)
    kv, mesh = cfg.n_kv_heads, get_mesh()
    if mesh is not None:
        if S.kv_shardable(cfg, mesh):
            kv //= mesh.axis_size("model")
        elif cfg.shard_cache_seq:
            raise ValueError(f"{cfg.name}: the sequence-split cache (shard_cache_seq) "
                             "does not run on a mesh yet")
        batch = local_rows(batch, mesh)
    shape = (batch, kv, max_len, cfg.head_dim_)
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
    """On a mesh: column-parallel wi (a rank's gate part and up part,
    ``sharding.layout``), row-parallel wo, the sum over ``model``."""
    mesh = get_mesh()
    if mesh is None:
        return _glu(kind, x @ p.wi) @ p.wo
    d = x.shape[-1]
    h = C.copy_to(x, "model", mesh) @ whole(p.wi, 0, d, mesh)
    return row_parallel(_glu(kind, h), whole(p.wo, 1, d, mesh), mesh)


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
    gather path of ``layers.py:200``; on a mesh, :func:`_moe_sharded`.

    Each token goes to its top-k experts by router probability (f32, padded
    experts masked with -1e9), weighted by the renormalised top-k
    probabilities. The T·k (token, slot) pairs are sorted stably by expert
    and each takes the next slot of its expert's ``moe_capacity`` slots
    (:func:`_queue_positions`); a pair past them goes to the drop bin (slot
    ``cap``) with weight 0. The experts run as two batched products over the
    (E, cap + 1, d) buffer (:func:`_experts`). Each token sums its k
    weighted outputs in f32 in ascending expert order, the order of the
    reference's sorted scatter-add (no atomics: the same sum on every run),
    casts to x's type and adds the shared and the dense MLPs. With
    ``stats``, adds the pairs dropped under ``"dropped"`` and the pairs
    routed under ``"routed"`` (a host sync each), and where it holds a list
    under ``"routing"``, appends each call's ``(topi, kept)``: the (T, k)
    experts and which pairs kept a slot.

    The backward is the same on every run, on the card too: no indexed op
    here sums two values into one place in an order that could change.

    - The buffer's rows are x broadcast over the k slots, one row a
      (token, slot) pair, so the backward sums each token's k rows in a
      fixed reduction. Taking ``xf[token]`` instead would repeat each token
      k times and sum its k gradients by an accumulating scatter.
    - Dropped pairs write zeros into a drop bin, so its several writes
      agree and its row, its expert outputs and its gradients are exactly
      zero whichever write lands.
    - ``hout[expert, slot]`` repeats an index only at the drop bins, whose
      weight is 0: its backward sums only signed zeros there, whose sum
      does not depend on the order.

    A recompute (remat) routes as the forward did: ``topk``, the stable
    sort and the capacity depend on x alone."""
    b, s, d = x.shape
    e, k = cfg.moe_experts_padded, cfg.moe_top_k
    t = b * s
    xf = x.reshape(t, d)
    probs = _router_probs(cfg, p, xf)
    mesh = get_mesh()
    if mesh is not None:
        contrib, topi, aux = _moe_sharded(cfg, p, xf, probs, mlp_kind, stats, mesh)
    else:
        topw, topi = _top_k(cfg, probs)
        cap = moe_capacity(cfg, t)
        pos = _queue_positions(topi.reshape(-1), e)
        kept = pos < cap
        if stats is not None:
            _record(stats, int((~kept).sum()), t * k, topi, kept)
        contrib = _experts(p, xf, topw, topi, pos, kept, cap, 0, e, mlp_kind, None)
        me = probs.mean(dim=0)
        ce = F.one_hot(topi, e).float().sum(dim=1).mean(dim=0)
        aux = e * torch.sum(me * ce)

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
    return y.reshape(b, s, d), aux


def _router_probs(cfg: ModelConfig, p: MoE, xf: torch.Tensor) -> torch.Tensor:
    """The router's softmax (T, E_pad) in f32, padded experts at -1e9."""
    e = cfg.moe_experts_padded
    logits = xf.float() @ p.router
    if e > cfg.moe_experts:
        logits = logits.masked_fill(torch.arange(e, device=xf.device) >= cfg.moe_experts, -1e9)
    return torch.softmax(logits, dim=-1)


def _top_k(cfg: ModelConfig, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    topw, topi = torch.topk(probs, cfg.moe_top_k, dim=-1)     # (T, k)
    return topw / topw.sum(dim=-1, keepdim=True), topi


def _queue_positions(flat_e: torch.Tensor, n: int) -> torch.Tensor:
    """Each pair's place in its expert's queue (pairs in order, stably
    sorted by expert; experts ``0..n-1``), in the pairs' own order."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(n, device=flat_e.device))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    return pos


def _record(stats: dict, dropped: int, routed: int, topi: torch.Tensor,
            kept: torch.Tensor) -> None:
    stats["dropped"] = stats.get("dropped", 0) + dropped
    stats["routed"] = stats.get("routed", 0) + routed
    if "routing" in stats:
        stats["routing"].append((topi.detach().cpu(), kept.reshape(topi.shape).cpu()))


def _experts(p: MoE, xf: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
             pos: torch.Tensor, kept: torch.Tensor, cap: int, first: int, count: int,
             mlp_kind: str, mesh) -> torch.Tensor:
    """Each (token, slot) pair's weighted expert output (T·k, d) in f32 for
    the pairs routed to experts ``[first, first + count)`` (the rank's
    experts; zeros for the others): every pair written into the (count,
    cap + 1, d) buffer at its queue position (a drop bin, slot ``cap``,
    where it was dropped or is another rank's), the experts' two batched
    products, each pair's row read back and weighted (0 in a drop bin).
    Masks, not a selection of the pairs: no host sync. The pairs not kept
    spread over every expert's drop bin: the backward of the read-back
    sums each bin's rows one after another, and one bin for all of them
    made a full-width training step 0.12 s slower on an H100."""
    t, k = topi.shape
    d = xf.shape[1]
    flat = topi.reshape(-1)
    ok = kept.reshape(-1) & (flat >= first) & (flat < first + count)
    e_loc = (flat - first) % count      # another rank's pairs: spread over the bins
    dest = torch.where(ok, pos, cap)
    rows = xf.unsqueeze(1).expand(t, k, d).reshape(t * k, d)           # (token, slot) order
    buf = torch.zeros((count, cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[e_loc, dest] = torch.where(ok[:, None], rows, 0)                # the drop bins: zeros
    w_in, w_out = p.w_in, p.w_out
    if mesh is not None:
        w_in, w_out = whole(w_in, 1, d, mesh), whole(w_out, 2, d, mesh)
    hout = torch.bmm(_glu(mlp_kind, torch.bmm(buf, w_in)), w_out)      # (count, cap+1, d)
    return hout[e_loc, dest].float() * (topw.reshape(-1) * ok)[:, None]


def _moe_sharded(cfg: ModelConfig, p: MoE, xf: torch.Tensor, probs: torch.Tensor,
                 mlp_kind: str, stats: dict | None, mesh):
    """The MoE on a rank's tokens (its data shard, whole over ``model``):
    ``(contrib, topi, aux)`` with ``contrib`` summed over ``model``.

    Experts lie on ``model`` when ``E_pad % tp == 0`` (rank r holds
    ``[r·E/tp, (r+1)·E/tp)`` and computes only their pairs), else every
    rank holds every expert's part of the hidden width and computes every
    pair in part. Each pair's weighted output is summed over ``model``
    (exact where experts are split: one rank holds a pair), then each token
    sums its slots in expert order as the whole layer does.

    - ``moe_impl="shard_map_ep"`` with experts split (the counterpart of
      ``_moe_forward_shard_map``, ``layers.py:266``): the capacity is local,
      ``ceil(t_loc·k·cf / E)``, over the rank's own tokens and experts.
    - Otherwise (``gather``, or experts not split): capacity and queue
      positions are over the global batch, as under GSPMD. The (t, k)
      routing indices are gathered over the data axes (data rank i holds
      global tokens ``[i·t, (i+1)·t)``), so every rank computes the
      global queues and drops exactly the pairs the whole layer drops.

    The tokens and the router's probabilities enter the dispatch through
    ``copy_to`` (each rank's pairs give part of their gradient) and the
    aux term as they are (the aux term is whole on every model rank). ``aux`` is over the
    global batch: the probabilities' and counts' sums over the data axes."""
    e, k = cfg.moe_experts_padded, cfg.moe_top_k
    t = xf.shape[0]
    dpx = S.dp_axes(mesh)
    dp, tp = mesh.axis_size(dpx), mesh.axis_size("model")
    topw, topi = _top_k(cfg, C.copy_to(probs, "model", mesh))
    ep = S.expert_parallel(cfg, mesh)
    first, count = (mesh.axis_index("model") * (e // tp), e // tp) if ep else (0, e)
    flat = topi.reshape(-1)
    if cfg.moe_impl == "shard_map_ep" and ep:
        cap = moe_capacity(cfg, t)
        mine = (flat >= first) & (flat < first + count)
        pos = _queue_positions(torch.where(mine, flat - first, count), count + 1)
        kept = mine & (pos < cap)
        if stats is not None:   # each pair is one model rank's
            kept_all = C.all_reduce(kept.to(torch.int32), "model", mesh=mesh) > 0
            _record(stats, int(C.all_reduce((~kept_all).sum(), dpx, mesh=mesh)), t * dp * k,
                    C.all_gather(topi, dpx, 0, mesh), C.all_gather(kept_all, dpx, 0, mesh))
    else:
        topi_g = C.all_gather(topi, dpx, 0, mesh)
        cap = moe_capacity(cfg, t * dp)
        pos_g = _queue_positions(topi_g.reshape(-1), e)
        mine = slice(mesh.axis_index(dpx) * t * k, (mesh.axis_index(dpx) + 1) * t * k)
        pos = pos_g[mine]
        kept = pos < cap
        if stats is not None:
            _record(stats, int((pos_g >= cap).sum()), t * dp * k, topi_g, pos_g < cap)
    contrib = _experts(p, C.copy_to(xf, "model", mesh), topw, topi, pos, kept, cap, first,
                       count, mlp_kind, mesh)
    contrib = C.reduce_from(contrib, "model", mesh)
    me = C.reduce_from(probs.sum(dim=0), dpx, mesh) / (t * dp)
    ce = C.all_reduce(F.one_hot(topi, e).float().sum(dim=1).sum(dim=0), dpx, mesh=mesh) / (t * dp)
    return contrib, topi, e * torch.sum(me * ce)


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
    ``dtype`` (default the model dtype). On a mesh, this rank's shard under
    ``strategy.cache_specs``: its data rows, ``conv_x`` on its d_inner
    columns and ``ssm`` on its heads (:func:`ssm_heads`), ``conv_bc``
    whole."""
    dt = dtype or torch_dtype(cfg)
    n, mesh = cfg.ssm_state, get_mesh()
    h = ssm_heads(cfg, mesh)[1]
    if mesh is not None:
        batch = local_rows(batch, mesh)
    k1 = cfg.ssm_conv_kernel - 1
    return {
        "conv_x": torch.zeros((batch, k1, h * cfg.ssm_head_dim), dtype=dt, device=device),
        "conv_bc": torch.zeros((batch, k1, 2 * n), dtype=dt, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def ssm_heads(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """``(first, count)``: the SSD heads this rank computes. Without a mesh,
    all of them; on one, ``[r·h/tp, (r+1)·h/tp)`` for model rank r, which
    are the d_inner columns ``[first·hd, (first + count)·hd)`` that its
    w_z / w_x / conv_x shards hold (d_inner is head-major) and the
    heads of its a_log / d_skip / dt_bias shards. Heads that do not divide
    over ``model`` (which the reference replicates) are refused."""
    h = cfg.ssm_heads
    if mesh is None:
        return 0, h
    tp = mesh.axis_size("model")
    if h % tp:
        raise ValueError(f"{cfg.name}: {h} SSD heads do not split {tp} ways over 'model' "
                         "(ssm_heads % tp != 0: the port does not replicate them)")
    return mesh.axis_index("model") * (h // tp), h // tp


def _ssm_shards(p: SSM, x: torch.Tensor, mesh):
    """``(x, (w_z, w_x, w_bc, w_dt, conv_bc_w, conv_bc_b, out_proj))``: the
    input and the weights :func:`ssm_forward` runs on. Without a mesh, x
    and the whole weights. On a mesh, x through ``copy_to`` (every product
    below uses it in part); w_z, w_x and out_proj the rank's d_inner
    columns and rows; w_bc, w_dt and the B/C conv whole on every model rank
    but used only for the rank's heads, so through ``copy_to`` (their
    gradients summed over ``model``); FSDP weights gathered
    (:func:`whole`)."""
    ws = (p.w_z, p.w_x, p.w_bc, p.w_dt, p.conv_bc_w, p.conv_bc_b, p.out_proj)
    if mesh is None:
        return x, ws
    d = x.shape[-1]
    w_z, w_x, w_bc, w_dt = (whole(w, 0, d, mesh) for w in ws[:4])
    w_bc, w_dt, conv_bc_w, conv_bc_b = (C.copy_to(w, "model", mesh)
                                        for w in (w_bc, w_dt, p.conv_bc_w, p.conv_bc_b))
    return C.copy_to(x, "model", mesh), (w_z, w_x, w_bc, w_dt, conv_bc_w, conv_bc_b,
                                         whole(p.out_proj, 1, d, mesh))


def _gated_norm(cfg: ModelConfig, g: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """RMSNorm of the gated product g (b, s, d_inner) with norm_w, over the
    whole d_inner. On a mesh a rank holds d_inner/tp columns of g, and a
    norm over them alone would divide by the wrong mean of squares without
    an error: g is gathered over ``model`` (``gather_from``, whose backward
    reduce-scatters the whole row's gradient; its bytes are counted under
    the tag ``gated_norm``), the RMSNorm kernel runs on whole rows, bitwise
    the unsharded norm, and the rank keeps its columns. norm_w is whole on
    every rank (the strategy replicates every ``*norm*`` tensor, as the
    reference's rule does before its SSM rules) and used in part, so it
    enters through ``copy_to``."""
    if mesh is None:
        return ops.rmsnorm(g, w, eps=cfg.norm_eps)
    di = g.shape[-1]
    rows = C.gather_from(g, "model", g.dim() - 1, mesh, tag="gated_norm").contiguous()
    full = ops.rmsnorm(rows, C.copy_to(w, "model", mesh), eps=cfg.norm_eps)
    first = mesh.axis_index("model") * di
    return full[..., first:first + di]


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
    d_inner.

    On a mesh the same body runs on the rank's SSD heads (:func:`ssm_heads`,
    :func:`_ssm_shards`): z, x and its conv on the rank's d_inner columns,
    B, C and dt computed whole and dt cut to the rank's heads, the scan (and
    on the card its kernel) and the decode recurrence on those heads, the
    gated norm over the gathered d_inner (:func:`_gated_norm`) and out_proj
    row-parallel; the cache is the rank's shard (:func:`make_ssm_cache`)."""
    b, s, _ = x.shape
    n, hd, mesh = cfg.ssm_state, cfg.ssm_head_dim, get_mesh()
    first, h = ssm_heads(cfg, mesh)
    di = h * hd
    x, (w_z, w_x, w_bc, w_dt, conv_bc_w, conv_bc_b, out_proj) = _ssm_shards(p, x, mesh)
    z = x @ w_z                                               # (b, s, di)
    xr = x @ w_x                                              # (b, s, di)
    bc = x @ w_bc                                             # (b, s, 2n)
    dt_raw = (x @ w_dt)[..., first:first + h]                 # (b, s, h)
    a = -torch.exp(p.a_log)                                   # (h,)

    new_cache = cache
    if cache is not None and s == 1:
        # decode: one recurrence step
        hist_x = torch.cat([cache["conv_x"], xr], dim=1)      # (b, k, di)
        hist_bc = torch.cat([cache["conv_bc"], bc], dim=1)
        cx = torch.einsum("bkc,kc->bc", hist_x.float(), p.conv_x_w.float()) \
            + p.conv_x_b.float()
        cbc = torch.einsum("bkc,kc->bc", hist_bc.float(), conv_bc_w.float()) \
            + conv_bc_b.float()
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
        cbc = F.silu(_causal_depthwise_conv(bc, conv_bc_w, conv_bc_b).float()).to(x.dtype)
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

    y = _gated_norm(cfg, y * F.silu(z.float()).to(x.dtype), p.norm_w, mesh)
    return (y @ out_proj if mesh is None else row_parallel(y, out_proj, mesh)), new_cache


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
