"""llama3-405b [dense] — arXiv:2407.21783. GQA (128 q / 8 kv heads), 128k vocab."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        head_dim=128,
        mlp_kind="glu",
        pattern=(("attn", "mlp"),),
        rope_theta=500000.0,
        opt_state_dtype="bfloat16",  # 405B: fp32 moments exceed v5e HBM
        microbatch_size=1,
        fsdp_params=True,            # 810GB bf16 weights need data-axis sharding
        remat_policy="block",
        notes="kv_heads (8) < TP (16): KV projections replicated across TP.",
    )
)
