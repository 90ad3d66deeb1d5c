"""stablelm-3b [dense] — hf:stabilityai. MHA (32q/32kv)."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        mlp_kind="glu",
        pattern=(("attn", "mlp"),),
        rope_theta=10000.0,
        microbatch_size=8,
    )
)
