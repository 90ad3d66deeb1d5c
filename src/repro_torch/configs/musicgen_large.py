"""musicgen-large [audio] — arXiv:2306.05284.

Decoder-only transformer over EnCodec tokens (vocab 2048). The EnCodec
frontend is a stub per the task spec: ``input_specs`` provides token ids
(training) / a KV cache (decode) directly."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_kind="glu",
        pattern=(("attn", "mlp"),),
        frontend="audio",
        rope_theta=10000.0,
        microbatch_size=8,
    )
)
