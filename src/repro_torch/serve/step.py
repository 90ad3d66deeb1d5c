"""Serving steps: batched prefill and single-token decode over the KV
cache, and a greedy generation loop; the counterpart of
``repro.serve.step``.

The steps run on a mesh too (``sharding.context``): the model and the
cache (``models.make_cache`` under the mesh) are then the rank's shards,
the tokens its data shard, and the logits come back as its vocabulary
columns. ``greedy_generate`` runs unsharded."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import Transformer, decode_step as _decode, make_cache
from ..models import prefill as _prefill
from ..sharding.context import get_mesh


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: Transformer, tokens: torch.Tensor, cache: list,
                     patch_embeds: torch.Tensor | None = None):
        return _prefill(cfg, params, tokens, cache, patch_embeds=patch_embeds)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params: Transformer, tokens: torch.Tensor, cache: list,
                    cache_pos: int):
        return _decode(cfg, params, tokens, cache, cache_pos)

    return decode_step


def greedy_generate(cfg: ModelConfig, params: Transformer, prompt: torch.Tensor,
                    max_new: int, device: str | torch.device | None = None,
                    patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill ``prompt`` (b, plen), after its ``patch_embeds`` (b, patches,
    d) for the ``vlm`` frontend, and decode ``max_new - 1`` more tokens,
    each the argmax over the real vocabulary; returns the ``max_new`` new
    tokens (b, max_new). Runs on ``device`` (default: the card), where
    ``params`` must lie, under ``torch.inference_mode()``."""
    if get_mesh() is not None:
        raise ValueError("greedy_generate runs unsharded: on a mesh the logits are "
                         "vocabulary shards (use the prefill and decode steps)")
    dev = resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"params lie on {params.embed.device}, generation runs on {dev}")
    with torch.inference_mode():
        prompt = prompt.to(dev)
        b, plen = prompt.shape
        if patch_embeds is not None:
            patch_embeds = patch_embeds.to(dev)
            plen += patch_embeds.shape[1]   # the patches hold the first positions
        cache = make_cache(cfg, b, plen + max_new, dev)
        logits, cache = _prefill(cfg, params, prompt, cache, patch_embeds=patch_embeds)
        out = [torch.argmax(logits[..., : cfg.vocab_size], dim=-1)]
        for i in range(max_new - 1):
            logits, cache = _decode(cfg, params, out[-1], cache, plen + i)
            out.append(torch.argmax(logits[..., : cfg.vocab_size], dim=-1))
        return torch.stack(out, dim=1)
