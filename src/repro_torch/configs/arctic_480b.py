"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base.

128 routed experts (top-2) in parallel with a dense residual FFN (d_ff=4864).
Experts shard EP over the model axis (128/16 = 8/device); weights additionally
FSDP over the data axis (936GB bf16 total). 56 heads padded to 64 for TP=16."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        head_dim=128,
        mlp_kind="glu",
        pattern=(("attn", "moe"),),
        moe_experts=128,
        moe_top_k=2,
        moe_d_ff=4864,
        moe_dense_residual=True,
        pad_heads_to=64,
        rope_theta=10000.0,
        opt_state_dtype="bfloat16",
        microbatch_size=1,
        fsdp_params=True,
        notes="dense residual FFN parallel to MoE; 56->64 head padding.",
    )
)
