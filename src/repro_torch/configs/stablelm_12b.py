"""stablelm-12b [dense] — hf:stabilityai. GQA kv=8."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        mlp_kind="glu",
        pattern=(("attn", "mlp"),),
        rope_theta=10000.0,
        microbatch_size=4,
        notes="kv_heads (8) < TP (16): KV projections replicated across TP.",
    )
)
