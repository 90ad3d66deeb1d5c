"""Config-driven decoder LM on PyTorch (serving of every architecture of
``configs/``: dense, MoE, Mamba-2, the hybrid, the VLM and audio frontends;
training of the decoders without Mamba-2 layers)."""
from . import layers
from .transformer import (
    ACT_NAMES,
    MOE_AUX_COEF,
    REMAT_POLICIES,
    Transformer,
    count_params_analytic,
    decode_step,
    embed_inputs,
    forward,
    init_params,
    lm_loss,
    make_cache,
    prefill,
)

__all__ = [
    "layers",
    "ACT_NAMES",
    "MOE_AUX_COEF",
    "REMAT_POLICIES",
    "Transformer",
    "lm_loss",
    "forward",
    "embed_inputs",
    "init_params",
    "prefill",
    "decode_step",
    "make_cache",
    "count_params_analytic",
]
