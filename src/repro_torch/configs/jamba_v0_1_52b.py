"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

Mamba:attention 7:1 interleave with MoE (16 experts, top-2) on every other
layer. Expressed as a scanned 8-sub-layer superblock (32 layers = 4 groups):
sub-layers 0-6 are Mamba, sub-layer 7 is attention; odd sub-layers use MoE.
"""
from .base import ModelConfig, register

_PATTERN = (
    ("ssm", "mlp"),
    ("ssm", "moe"),
    ("ssm", "mlp"),
    ("ssm", "moe"),
    ("ssm", "mlp"),
    ("ssm", "moe"),
    ("ssm", "mlp"),
    ("attn", "moe"),
)

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=_PATTERN,
        moe_experts=16,
        moe_top_k=2,
        moe_d_ff=14336,
        ssm_state=16,           # Jamba uses Mamba-1 state size 16
        ssm_head_dim=64,
        ssm_expand=2,
        rope_theta=10000.0,
        microbatch_size=1,
        fsdp_params=True,
        notes=(
            "kv_heads (8) < TP (16): KV replicated. long_500k runs (hybrid: "
            "SSM layers are O(1)/token; the 4 attention layers keep a full "
            "KV cache, linear per decoded token)."
        ),
    )
)
