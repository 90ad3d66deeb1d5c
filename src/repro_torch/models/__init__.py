"""Config-driven decoder LM on PyTorch (the serving path of dense decoders)."""
from . import layers
from .transformer import (
    Transformer,
    count_params_analytic,
    decode_step,
    embed_inputs,
    forward,
    init_params,
    make_cache,
    prefill,
)

__all__ = [
    "layers",
    "Transformer",
    "forward",
    "embed_inputs",
    "init_params",
    "prefill",
    "decode_step",
    "make_cache",
    "count_params_analytic",
]
