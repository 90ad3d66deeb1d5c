"""llava-next-34b [vlm] — backbone only (anyres frontend is a stub).

``input_specs`` supplies precomputed patch embeddings (per task spec); the
backbone prepends them to token embeddings. 56 heads are padded to 64 for
TP=16 (zero-initialized pad slices are exact no-ops, ~14% attention-FLOP
overhead reported in the roofline notes)."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        head_dim=128,
        mlp_kind="glu",
        pattern=(("attn", "mlp"),),
        pad_heads_to=64,
        frontend="vlm",
        vlm_patches=576,
        rope_theta=10000.0,
        microbatch_size=1,
        notes="56 q heads padded to 64 for TP=16; kv=8 replicated across TP.",
    )
)
