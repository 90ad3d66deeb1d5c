"""gemma-7b [dense] — arXiv:2403.08295. GeGLU, explicit head_dim=256, tied embeds."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        d_ff=24576,
        vocab_size=256000,
        head_dim=256,        # explicit: 16*256 = 4096 != d_model
        mlp_kind="geglu",
        pattern=(("attn", "mlp"),),
        tie_embeddings=True,
        rope_theta=10000.0,
        microbatch_size=4,
    )
)
