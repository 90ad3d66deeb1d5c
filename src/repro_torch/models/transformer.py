"""The decoder LM on PyTorch: init / forward / loss / prefill / decode, the
counterpart of ``repro.models.transformer`` for dense decoders and Mamba-2.

The model is an ``nn.Module`` (:class:`Transformer`) holding one
:class:`Block` per layer in an ``nn.ModuleList``; the JAX package stacks
the layers on a leading group axis and scans over them, the port loops.
The functions keep the JAX package's signatures (``forward(cfg, params,
tokens, ...)``) so the tests compare like with like. The decode cache is a
list with one entry per layer: an attention layer's ``{"k", "v"}``, written
in place (the JAX package returns a new stacked cache; in place saves the
second copy), or a Mamba-2 layer's ``{"conv_x", "conv_bc", "ssm"}``, whose
tensors each forward replaces with the state ``ssm_forward`` returns.

Served here: every architecture of ``configs/``: layers of attention or
Mamba-2 with a dense MLP, an MoE feed-forward (``layers.MoE``) or none;
token inputs (``audio``: EnCodec tokens, the reference's stub) or, for
``vlm``, patch embeddings projected by ``patch_adapter`` and prepended to
the tokens'. ``forward`` returns the MoE layers' load-balancing loss summed
over the layers. Trained: every architecture; a Mamba-2 layer's SSD scan
takes its gradient from ``kernels.ssd_scan.SSDScan``.

Rematerialisation (``cfg.remat_policy``) wraps each layer of a forward that
records a graph in ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of ``_remat_wrap`` (``transformer.py:148``): ``none`` saves
everything; ``block`` makes one checkpoint region per layer, which saves
only the layer's input; ``dots`` saves the outputs of the matrix products
(``create_selective_checkpoint_contexts``, as ``checkpoint_dots``);
``planner`` saves exactly the named activations the planner chose (and the
layer input) by cutting the layer into regions at them. Of ``ACT_NAMES``
only ``mixer_out`` is read by a backward (the MLP's recompute needs
``x + mixer_out``); ``ffn_out`` and ``block_out`` feed sums, whose backward
saves nothing, so a cut there changes nothing. Under ``torch.no_grad`` or
``inference_mode`` no region is made.
"""
from __future__ import annotations

import functools
import math
from collections.abc import Callable

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from ..sharding import collectives as C
from ..sharding import strategy as S
from ..sharding.context import get_mesh
from . import layers as L

MOE_AUX_COEF = 0.01
# the named activations a remat policy or the activation planner may save
ACT_NAMES = ("mixer_out", "ffn_out", "block_out")
REMAT_POLICIES = ("none", "block", "dots", "planner")
FRONTENDS = ("tokens", "audio", "vlm")   # audio: EnCodec tokens (a stub upstream)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a mixer, feed-forward or frontend that no
    model of the JAX package has."""
    for mixer, mlp in cfg.pattern:
        if mixer not in ("attn", "ssm") or mlp not in ("mlp", "moe", None):
            raise ValueError(f"{cfg.name}: unknown layer kind {(mixer, mlp)}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str | None]]:
    """Each layer's (mixer, mlp): ``cfg.pattern`` repeated over the groups
    (group g's sub-layer i is layer ``g * len(cfg.pattern) + i``)."""
    return [cfg.pattern[n % len(cfg.pattern)] for n in range(cfg.n_layers)]


class Block(nn.Module):
    """One layer: norm1, the mixer (attention or Mamba-2), and norm2 with
    the feed-forward (a dense MLP or an MoE), or neither where the layer has
    no feed-forward (Mamba-2)."""

    def __init__(self, norm1: torch.Tensor, mixer: L.Attention | L.SSM,
                 norm2: torch.Tensor | None = None, ffn: L.MLP | L.MoE | None = None):
        super().__init__()
        if (norm2 is None) != (ffn is None):
            raise ValueError("a block has both norm2 and ffn or neither")
        self.norm1 = L.weight(norm1)
        self.mixer = mixer
        self.norm2 = None if norm2 is None else L.weight(norm2)
        self.ffn = ffn


class Transformer(nn.Module):
    """The whole model's weights: ``embed`` (vocab_padded, d), the layers,
    ``final_norm``, unless embeddings are tied ``lm_head`` (d, vocab_padded),
    and for the ``vlm`` frontend ``patch_adapter`` (d, d). The module-level
    functions run it."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, layers: list[Block],
                 final_norm: torch.Tensor, lm_head: torch.Tensor | None,
                 patch_adapter: torch.Tensor | None = None):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config has {cfg.n_layers}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given iff embeddings are untied")
        if (patch_adapter is None) != (cfg.frontend != "vlm"):
            raise ValueError(f"{cfg.name}: patch_adapter must be given iff the frontend "
                             "is vlm")
        self.cfg = cfg
        self.embed = L.weight(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.weight(final_norm)
        self.lm_head = None if lm_head is None else L.weight(lm_head)
        self.patch_adapter = None if patch_adapter is None else L.weight(patch_adapter)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None, *,
                place: Callable[[str, torch.Tensor], torch.Tensor] | None = None
                ) -> Transformer:
    """A model on ``device`` (default: the card) with random weights drawn
    from ``generator`` (a generator on that device), at the JAX package's
    scales: normal embeddings and projections scaled by 1/sqrt(fan-in), unit
    norms. The draws are not JAX's threefry bits; parity tests carry weights
    across with ``convert.params_from_reference``. ``place(name, tensor)``,
    where given, replaces each tensor as soon as its layer (or the
    embedding, the head) is drawn: ``sharding.layout.init_sharded_params``
    keeps a rank's shard this way, the draws unchanged."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    dt, d, gen = L.torch_dtype(cfg), cfg.d_model, generator
    keep = place or (lambda name, t: t)

    def placed(prefix: str, module: nn.Module) -> nn.Module:
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.data = keep(f"{prefix}.{name}", p.data)
        return module

    ones = lambda: torch.ones(d, dtype=dt, device=dev)  # noqa: E731
    embed = keep("embed", L.normal(gen, (cfg.vocab_padded, d), 1.0 / math.sqrt(d), dt))
    layers = []
    for n, (mixer, mlp) in enumerate(layer_kinds(cfg)):
        mix = L.init_attention(cfg, gen) if mixer == "attn" else L.init_ssm(cfg, gen)
        ffn = () if mlp is None else (
            ones(), L.init_moe(cfg, gen) if mlp == "moe" else L.init_mlp(cfg, gen))
        layers.append(placed(f"layers.{n}", Block(ones(), mix, *ffn)))
    lm_head = (None if cfg.tie_embeddings
               else keep("lm_head", L.normal(gen, (d, cfg.vocab_padded), 1.0 / math.sqrt(d), dt)))
    adapter = (keep("patch_adapter", L.normal(gen, (d, d), 1.0 / math.sqrt(d), dt))
               if cfg.frontend == "vlm" else None)
    return Transformer(cfg, embed, layers, keep("final_norm", ones()), lm_head, adapter)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Name → shape of every parameter ``init_params`` makes, without
    allocating one (the sharding specs and audit of the largest configs
    read these)."""
    check_supported(cfg)
    d, hd, V = cfg.d_model, cfg.head_dim_, cfg.vocab_padded
    hp, kv = cfg.n_heads_padded, cfg.n_kv_heads
    out = {"embed": (V, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, V)
    if cfg.frontend == "vlm":
        out["patch_adapter"] = (d, d)

    def mlp(pre: str, ff: int) -> None:
        out[f"{pre}.wi"], out[f"{pre}.wo"] = (d, 2 * ff), (ff, d)

    for n, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        pre = f"layers.{n}"
        out[f"{pre}.norm1"] = (d,)
        if ffn is not None:
            out[f"{pre}.norm2"] = (d,)
        if mixer == "attn":
            out.update({f"{pre}.mixer.wq": (d, hp * hd), f"{pre}.mixer.wk": (d, kv * hd),
                        f"{pre}.mixer.wv": (d, kv * hd), f"{pre}.mixer.wo": (hp * hd, d)})
        else:
            di, sn, h, k = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_kernel
            shapes = dict(w_z=(d, di), w_x=(d, di), w_bc=(d, 2 * sn), w_dt=(d, h),
                          conv_x_w=(k, di), conv_x_b=(di,), conv_bc_w=(k, 2 * sn),
                          conv_bc_b=(2 * sn,), a_log=(h,), d_skip=(h,), dt_bias=(h,),
                          norm_w=(di,), out_proj=(di, d))
            out.update({f"{pre}.mixer.{k_}": shapes[k_] for k_ in L.SSM_NAMES})
        if ffn == "mlp":
            mlp(f"{pre}.ffn", cfg.d_ff)
        elif ffn == "moe":
            e, ffe = cfg.moe_experts_padded, cfg.moe_d_ff
            out.update({f"{pre}.ffn.router": (d, e), f"{pre}.ffn.w_in": (e, d, 2 * ffe),
                        f"{pre}.ffn.w_out": (e, ffe, d)})
            if cfg.moe_shared_experts:
                mlp(f"{pre}.ffn.shared", cfg.moe_shared_experts * ffe)
            if cfg.moe_dense_residual:
                mlp(f"{pre}.ffn.dense", cfg.d_ff)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The token embeddings (b, s, d); for the ``vlm`` frontend with
    ``patch_embeds`` (b, patches, d), ``patch_embeds @ patch_adapter`` in
    the model's type prepended (``transformer.py:166``: a prompt carries
    its patches, decode steps none). Other frontends take no patches."""
    mesh = get_mesh()
    if mesh is not None:
        if patch_embeds is not None:
            raise ValueError(f"{cfg.name}: the vlm frontend does not run on a mesh yet")
        return _embed_sharded(cfg, params, tokens, mesh)
    x = params.embed[tokens]
    if patch_embeds is None:
        return x
    if cfg.frontend != "vlm":
        raise ValueError(f"{cfg.name}: the {cfg.frontend!r} frontend takes no patch "
                         "embeddings")
    return torch.cat([patch_embeds.to(x.dtype) @ params.patch_adapter, x], dim=1)


def _vocab_part(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """``(first, count)``: the vocabulary rows (embed) and columns (head)
    this model rank holds."""
    count = cfg.vocab_padded // mesh.axis_size("model")
    return mesh.axis_index("model") * count, count


def _embed_sharded(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                   mesh) -> torch.Tensor:
    """The embedding with its rows over ``model``: each rank looks up the
    tokens its rows hold (zeros for the rest), and the sum over ``model``
    adds one non-zero row a token."""
    first, count = _vocab_part(cfg, mesh)
    embed = L.whole(params.embed, 1, cfg.d_model, mesh)
    mine = (tokens >= first) & (tokens < first + count)
    x = embed[torch.where(mine, tokens - first, 0)]
    return C.reduce_from(torch.where(mine[..., None], x, 0), "model", mesh)


def _head(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Logits of the normed final activations (b, s, vocab_padded), -1e9 on
    the padded vocabulary; on a mesh this rank's columns (b, s, V/tp): the
    head's columns lie on ``model``, as the reference's ``out_shardings``
    keep the logits."""
    mesh, d = get_mesh(), cfg.d_model
    if mesh is None:
        first, count = 0, cfg.vocab_padded
        head = params.embed.T if cfg.tie_embeddings else params.lm_head
    else:
        first, count = _vocab_part(cfg, mesh)
        head = (L.whole(params.embed, 1, d, mesh).T if cfg.tie_embeddings
                else L.whole(params.lm_head, 0, d, mesh))
        x = C.copy_to(x, "model", mesh)
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(first, first + count, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


def _mixer_out(cfg: ModelConfig, layer: Block, x: torch.Tensor, positions: torch.Tensor,
               cache: dict | None = None, cache_pos: int | None = None) -> torch.Tensor:
    """The mixer on ``rmsnorm(x)``. A Mamba-2 layer's cache entry gets the
    state ``ssm_forward`` returns (an attention layer's is written in
    place)."""
    h = ops.rmsnorm(x, layer.norm1, eps=cfg.norm_eps)
    if isinstance(layer.mixer, L.SSM):
        y, state = L.ssm_forward(cfg, layer.mixer, h, cache=cache)
        if cache is not None:
            cache.update(state)
        return y
    return L.attention_forward(cfg, layer.mixer, h, positions, cache=cache,
                               cache_pos=cache_pos)


def _ffn_out(cfg: ModelConfig, layer: Block, x: torch.Tensor, moe_stats: dict | None = None
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The feed-forward on ``rmsnorm(x)`` and its MoE loss (``None`` for a
    dense MLP)."""
    h = ops.rmsnorm(x, layer.norm2, eps=cfg.norm_eps)
    if isinstance(layer.ffn, L.MoE):
        return L.moe_forward(cfg, layer.ffn, h, cfg.mlp_kind, moe_stats)
    return L.mlp_forward(cfg.mlp_kind, layer.ffn, h), None


def _block(cfg: ModelConfig, layer: Block, x: torch.Tensor, positions: torch.Tensor,
           cache: dict | None = None, cache_pos: int | None = None,
           moe_stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: ``x + mixer_out``, then ``+ ffn_out`` where the layer has
    a feed-forward (= ``block_out``); and the layer's MoE loss or ``None``."""
    x = x + _mixer_out(cfg, layer, x, positions, cache, cache_pos)
    if layer.ffn is None:
        return x, None
    f, aux = _ffn_out(cfg, layer, x, moe_stats)
    return x + f, aux


def _ffn_after(cfg: ModelConfig, layer: Block, x: torch.Tensor,
               y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    return _ffn_out(cfg, layer, x + y)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(cfg: ModelConfig, layer: Block, x: torch.Tensor, positions: torch.Tensor,
                 save_names: tuple[str, ...]) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`_block` under ``cfg.remat_policy`` (see the module docstring).
    No region uses random numbers, so none saves the RNG state."""
    policy = cfg.remat_policy
    if policy == "none":
        return _block(cfg, layer, x, positions)
    remat = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)
    if policy == "block":
        return remat(_block, cfg, layer, x, positions)
    if policy == "dots":
        return remat(_block, cfg, layer, x, positions,
                     context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                  _save_dots))
    if policy == "planner":
        if "mixer_out" not in (save_names or ACT_NAMES):
            return remat(_block, cfg, layer, x, positions)
        y = remat(_mixer_out, cfg, layer, x, positions)
        if layer.ffn is None:
            return x + y, None
        f, aux = remat(_ffn_after, cfg, layer, x, y)
        return (x + y) + f, aux
    raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")


def forward(
    cfg: ModelConfig,
    params: Transformer,
    tokens: torch.Tensor,            # (b, s)
    patch_embeds: torch.Tensor | None = None,
    cache: list | None = None,       # one entry per layer (make_cache)
    cache_pos: int | None = None,
    save_names: tuple[str, ...] = (),
    moe_stats: dict | None = None,
):
    """Returns ``(logits, moe_aux, cache)``: logits (b, s, vocab_padded)
    with -1e9 on the padded vocabulary; ``moe_aux`` (f32) the MoE layers'
    load-balancing losses summed in layer order (0 without MoE layers), as
    the reference's scan carries it; ``moe_stats``, where given, gathers
    the MoE layers' dropped and routed (token, expert) pairs
    (``layers.moe_forward``) of a forward that records no graph. Without a
    cache every attention goes through the flash-attention
    forward and every Mamba-2 layer through the SSD scan, and a forward that
    records a graph rematerialises each layer under ``cfg.remat_policy``
    (``save_names``: the planner's choice, for ``planner``); with a cache,
    k/v are written at ``cache_pos`` in place and each Mamba-2 layer's state
    is replaced (s > 1: the state after the prompt, from an empty one).

    On a mesh (``sharding.context``) the parameters, tokens and cache are
    the rank's shards (batch rows over the data axes) and the logits are
    its vocabulary columns; the MoE's aux is over the global batch. Every
    layer kind runs there: attention, Mamba-2, dense MLPs and MoE."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    b, s, _ = x.shape
    start = 0 if cache_pos is None else int(cache_pos)
    positions = torch.arange(start, start + s, device=x.device)
    if cache is not None and len(cache) != len(params.layers):
        raise ValueError(f"cache has {len(cache)} layers, model {len(params.layers)}")

    remat = cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        if remat:
            x, a = _remat_block(cfg, layer, x, positions, save_names)
        else:
            x, a = _block(cfg, layer, x, positions,
                          None if cache is None else cache[i], cache_pos, moe_stats)
        if a is not None:
            aux = aux + a

    x = ops.rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    return _head(cfg, params, x), aux, cache


# ---------------------------------------------------------------------------
# loss / prefill / decode
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: Transformer, batch: dict,
            save_names: tuple[str, ...] = ()) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL over labels >= 0, in f32, plus the z-loss
    ``1e-4·mean(logz²)`` and ``MOE_AUX_COEF·aux / n_layers``, as
    ``transformer.py:233``. Returns ``(total, {"nll", "zloss", "moe_aux",
    "ntok"})``; on a mesh, the global batch's (:func:`_lm_loss_sharded`)."""
    logits, aux, _ = forward(cfg, params, batch["tokens"],
                             patch_embeds=batch.get("patch_embeds"),
                             save_names=save_names)
    labels = batch["labels"]
    mesh = get_mesh()
    if mesh is not None:
        return _lm_loss_sharded(cfg, logits.float(), labels, aux, mesh)
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    ntok = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / ntok
    zloss = 1e-4 * torch.sum((logz * mask) ** 2) / ntok
    total = loss + zloss + MOE_AUX_COEF * aux / max(cfg.n_layers, 1)
    return total, {"nll": loss, "zloss": zloss, "moe_aux": aux, "ntok": ntok}


def _lm_loss_sharded(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                     aux: torch.Tensor, mesh) -> tuple[torch.Tensor, dict]:
    """:func:`lm_loss` of the global batch from a rank's rows and
    vocabulary columns: ``logsumexp`` from the maximum and the sum of
    exponentials over ``model``, the label's logit from the rank that holds
    it, the token count and the sums over the data axes. The value is the
    same on every rank; each rank's gradients are its rows' part (the train
    step sums them over the data axes)."""
    dpx = S.dp_axes(mesh)
    first, count = _vocab_part(cfg, mesh)
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    top = C.all_reduce(logits.detach().amax(dim=-1), "model", "max", mesh)
    sumexp = C.reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1), "model", mesh)
    logz = top + torch.log(sumexp)
    mine = (safe >= first) & (safe < first + count)
    ll = torch.gather(logits, -1, torch.where(mine, safe - first, 0)[..., None])[..., 0]
    ll = C.reduce_from(torch.where(mine, ll, 0), "model", mesh)
    nll = (logz - ll) * mask
    ntok = torch.clamp(C.all_reduce(mask.sum(), dpx, mesh=mesh), min=1.0)
    loss = C.reduce_from(nll.sum(), dpx, mesh) / ntok
    zloss = 1e-4 * C.reduce_from(torch.sum((logz * mask) ** 2), dpx, mesh) / ntok
    total = loss + zloss + MOE_AUX_COEF * aux / max(cfg.n_layers, 1)
    return total, {"nll": loss, "zloss": zloss, "moe_aux": aux, "ntok": ntok}


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> list[dict]:
    """A zeroed decode cache on ``device`` (default: the card), one entry
    per layer: ``{"k", "v"}`` of (batch, kv, max_len, hd) for attention,
    ``{"conv_x", "conv_bc", "ssm"}`` (``layers.make_ssm_cache``) for
    Mamba-2. On a mesh, this rank's shard under ``strategy.cache_specs``
    (``batch`` is the global batch)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [L.make_kv_cache(cfg, batch, max_len, dev) if mixer == "attn"
            else L.make_ssm_cache(cfg, batch, dev) for mixer, _ in layer_kinds(cfg)]


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            cache: list, patch_embeds: torch.Tensor | None = None,
            moe_stats: dict | None = None):
    """Consume a prompt (after its patches, for ``vlm``), fill the cache,
    return last-position logits."""
    logits, _, cache = forward(cfg, params, tokens, patch_embeds=patch_embeds,
                               cache=cache, cache_pos=0, moe_stats=moe_stats)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: list, cache_pos: int, moe_stats: dict | None = None):
    """One token step. tokens: (b,); cache_pos: the tokens' position."""
    logits, _, cache = forward(cfg, params, tokens[:, None], cache=cache,
                               cache_pos=cache_pos, moe_stats=moe_stats)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg`` by formula, for every architecture (the same
    count as ``repro.models.transformer.count_params_analytic``)."""
    d, hd = cfg.d_model, cfg.head_dim_
    hp, kv = cfg.n_heads_padded, cfg.n_kv_heads
    total = cfg.vocab_padded * d  # embed
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_padded
    if cfg.frontend == "vlm":
        total += d * d

    per_pattern = 0
    for mixer, mlp in cfg.pattern:
        per_pattern += d  # norm1
        if mixer == "attn":
            per_pattern += d * hp * hd + 2 * d * kv * hd + hp * hd * d
        else:
            di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
            per_pattern += d * (2 * di + 2 * n + h)              # w_z/x/bc/dt
            per_pattern += cfg.ssm_conv_kernel * (di + 2 * n) + (di + 2 * n)
            per_pattern += 3 * h + di + di * d                   # a/D/dt_b, norm, out
        if mlp is not None:
            per_pattern += d  # norm2
            if mlp == "moe":
                e = cfg.moe_top_k if active_only else cfg.moe_experts
                per_pattern += d * cfg.moe_experts  # router (always dense)
                per_pattern += e * 3 * d * cfg.moe_d_ff
                if cfg.moe_shared_experts:
                    per_pattern += 3 * d * cfg.moe_shared_experts * cfg.moe_d_ff
                if cfg.moe_dense_residual:
                    per_pattern += 3 * d * cfg.d_ff
            else:
                per_pattern += 3 * d * cfg.d_ff
    total += cfg.n_groups * per_pattern + d  # final norm
    return int(total)
