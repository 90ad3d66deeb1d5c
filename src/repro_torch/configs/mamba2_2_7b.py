"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD). Attention-free, state=128.

vocab 50280 is not divisible by TP=16 → padded to 50304 (next multiple of
128); padded logits are masked in loss/decoding."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,                 # attention-free, no MLP: SSD blocks only
        vocab_size=50280,
        pattern=(("ssm", None),),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,           # d_inner = 5120, 80 SSD heads
        pad_vocab_to=128,       # 50280 -> 50304 (divisible by TP=16)
        microbatch_size=8,
    )
)
