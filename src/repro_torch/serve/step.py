"""Serving steps: batched prefill and single-token decode over the KV
cache, and a greedy generation loop; the counterpart of
``repro.serve.step``."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import Transformer, decode_step as _decode, make_cache
from ..models import prefill as _prefill


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: Transformer, tokens: torch.Tensor, cache: list):
        return _prefill(cfg, params, tokens, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params: Transformer, tokens: torch.Tensor, cache: list,
                    cache_pos: int):
        return _decode(cfg, params, tokens, cache, cache_pos)

    return decode_step


def greedy_generate(cfg: ModelConfig, params: Transformer, prompt: torch.Tensor,
                    max_new: int, device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Prefill ``prompt`` (b, plen) and decode ``max_new - 1`` more tokens,
    each the argmax over the real vocabulary; returns the ``max_new`` new
    tokens (b, max_new). Runs on ``device`` (default: the card), where
    ``params`` must lie, under ``torch.inference_mode()``."""
    dev = resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"params lie on {params.embed.device}, generation runs on {dev}")
    with torch.inference_mode():
        prompt = prompt.to(dev)
        b, plen = prompt.shape
        cache = make_cache(cfg, b, plen + max_new, dev)
        logits, cache = _prefill(cfg, params, prompt, cache)
        out = [torch.argmax(logits[..., : cfg.vocab_size], dim=-1)]
        for i in range(max_new - 1):
            logits, cache = _decode(cfg, params, out[-1], cache, plen + i)
            out.append(torch.argmax(logits[..., : cfg.vocab_size], dim=-1))
        return torch.stack(out, dim=1)
