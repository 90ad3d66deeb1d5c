"""The decoder LM on PyTorch: init / forward / prefill / decode, the
counterpart of ``repro.models.transformer`` for the serving path.

The model is an ``nn.Module`` (:class:`Transformer`) holding one
:class:`Block` per layer in an ``nn.ModuleList``; the JAX package stacks
the layers on a leading group axis and scans over them, the port loops.
The functions keep the JAX package's signatures (``forward(cfg, params,
tokens, ...)``) so the tests compare like with like. The decode cache is a
list with one ``{"k", "v"}`` per layer, written in place (the JAX package
returns a new stacked cache; in place saves the second copy).

Served here: dense decoders whose layers are all ("attn", "mlp") and whose
inputs are tokens. MoE and Mamba-2 layers, the VLM and audio frontends, the
loss and rematerialisation come with later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from . import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet."""
    for mixer, mlp in cfg.pattern:
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the {mixer!r} (Mamba-2 SSD) mixer comes with the "
                "training slice of the port")
        if mlp != "mlp":
            raise NotImplementedError(
                f"{cfg.name}: the {mlp!r} feed-forward (MoE) comes with a later "
                "slice of the port")
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend comes with a later slice "
            "of the port")


class Block(nn.Module):
    """One layer: norm1, the attention mixer, norm2, the MLP."""

    def __init__(self, norm1: torch.Tensor, mixer: L.Attention,
                 norm2: torch.Tensor, ffn: L.MLP):
        super().__init__()
        self.norm1 = L.weight(norm1)
        self.mixer = mixer
        self.norm2 = L.weight(norm2)
        self.ffn = ffn


class Transformer(nn.Module):
    """The whole model's weights: ``embed`` (vocab_padded, d), the layers,
    ``final_norm`` and, unless embeddings are tied, ``lm_head``
    (d, vocab_padded). The module-level functions run it."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, layers: list[Block],
                 final_norm: torch.Tensor, lm_head: torch.Tensor | None):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config has {cfg.n_layers}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given iff embeddings are untied")
        self.cfg = cfg
        self.embed = L.weight(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.weight(final_norm)
        self.lm_head = None if lm_head is None else L.weight(lm_head)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Transformer:
    """A model on ``device`` (default: the card) with random weights drawn
    from ``generator`` (a generator on that device), at the JAX package's
    scales: normal embeddings and projections scaled by 1/sqrt(fan-in), unit
    norms. The draws are not JAX's threefry bits; parity tests carry weights
    across with ``convert.params_from_reference``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    dt, d, gen = L.torch_dtype(cfg), cfg.d_model, generator
    ones = lambda: torch.ones(d, dtype=dt, device=dev)  # noqa: E731
    embed = L.normal(gen, (cfg.vocab_padded, d), 1.0 / math.sqrt(d), dt)
    layers = [Block(ones(), L.init_attention(cfg, gen), ones(), L.init_mlp(cfg, gen))
              for _ in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings
               else L.normal(gen, (d, cfg.vocab_padded), 1.0 / math.sqrt(d), dt))
    return Transformer(cfg, embed, layers, ones(), lm_head)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    if patch_embeds is not None:
        raise NotImplementedError("patch embeddings (the VLM frontend) come with a "
                                  "later slice of the port")
    return params.embed[tokens]


def forward(
    cfg: ModelConfig,
    params: Transformer,
    tokens: torch.Tensor,            # (b, s)
    patch_embeds: torch.Tensor | None = None,
    cache: list | None = None,       # one {"k", "v"} per layer
    cache_pos: int | None = None,
):
    """Returns ``(logits, moe_aux, cache)``: logits (b, s, vocab_padded)
    with -1e9 on the padded vocabulary; ``moe_aux`` is 0 (no MoE layers
    here). Without a cache every attention goes through the flash-attention
    forward; with one, k/v are written at ``cache_pos`` in place."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    b, s, _ = x.shape
    start = 0 if cache_pos is None else int(cache_pos)
    positions = torch.arange(start, start + s, device=x.device)
    if cache is not None and len(cache) != len(params.layers):
        raise ValueError(f"cache has {len(cache)} layers, model {len(params.layers)}")

    for i, layer in enumerate(params.layers):
        h = ops.rmsnorm(x, layer.norm1, eps=cfg.norm_eps)
        x = x + L.attention_forward(cfg, layer.mixer, h, positions,
                                    cache=None if cache is None else cache[i],
                                    cache_pos=cache_pos)
        h2 = ops.rmsnorm(x, layer.norm2, eps=cfg.norm_eps)
        x = x + L.mlp_forward(cfg.mlp_kind, layer.ffn, h2)

    x = ops.rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> list[dict]:
    """A zeroed decode cache, one ``{"k", "v"}`` of (batch, kv, max_len, hd)
    per layer, on ``device`` (default: the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [L.make_kv_cache(cfg, batch, max_len, dev) for _ in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            cache: list, patch_embeds: torch.Tensor | None = None):
    """Consume a prompt, fill the cache, return last-position logits."""
    logits, _, cache = forward(cfg, params, tokens, patch_embeds=patch_embeds,
                               cache=cache, cache_pos=0)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: list, cache_pos: int):
    """One token step. tokens: (b,); cache_pos: the tokens' position."""
    logits, _, cache = forward(cfg, params, tokens[:, None], cache=cache,
                               cache_pos=cache_pos)
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
