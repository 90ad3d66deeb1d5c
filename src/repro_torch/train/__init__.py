"""Training: AdamW, the microbatched train step, the training loop."""
from .optimizer import AdamWConfig, adamw_update, global_norm, init_opt_state, lr_at
from .step import init_train_state, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "lr_at",
    "make_train_step",
    "init_train_state",
]
