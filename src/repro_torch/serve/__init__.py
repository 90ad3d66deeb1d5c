"""Serving: prefill/decode steps and greedy generation."""
from .step import greedy_generate, make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate"]
