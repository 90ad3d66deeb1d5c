"""Model kernels: hand-written CUDA for the card, plain PyTorch versions for
the CPU and as the oracle (``ref``). The entry points are ``ops.rmsnorm``,
``ops.flash_attention``, ``flash_attention_fwd`` (with the log-sum-exp),
``flash_attention_bwd`` and ``ops.ssd_scan``; the submodules ``rmsnorm``,
``flash_attention`` and ``ssd_scan`` keep their names here."""
from . import ops, ref
from .flash_attention import flash_attention_bwd, flash_attention_fwd

__all__ = ["ops", "ref", "flash_attention_fwd", "flash_attention_bwd"]
