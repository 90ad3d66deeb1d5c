"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

60 routed experts (top-4) + 4 always-on shared experts, per-expert ffn 1408.
60 is not divisible by TP=16 (nor 8), so expert-parallelism is avoided
entirely: experts are replicated across TP and each expert's 1408-wide ffn is
TP-sharded (1408/16 = 88)."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5632,               # shared-expert path width (4 x 1408)
        vocab_size=151936,
        mlp_kind="glu",
        pattern=(("attn", "moe"),),
        moe_experts=60,
        moe_top_k=4,
        moe_shared_experts=4,
        moe_d_ff=1408,
        rope_theta=10000.0,
        microbatch_size=4,
        notes="60 experts ∤ 16: EP avoided, per-expert ffn TP-sharded instead.",
    )
)
