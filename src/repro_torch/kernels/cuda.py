"""C entry points of the model kernels (``csrc/rmsnorm.cu``,
``csrc/flash_attention.cu``: the forward and the two backward kernels on
the CUDA cores; ``csrc/flash_attention_mma.cu``: the bf16 forward, dq and
dk/dv on the tensor cores; ``csrc/ssd_scan.cu``) and their launch counters.

Each wrapper launches through :func:`repro_torch.native.launch`, which
counts the launch (and a variant's) once it was accepted; nothing else
touches the counters. ``repro_torch.kernels.ops`` re-exports them as
``ops.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import native

KERNELS = ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ssd_scan")
launches = native.LaunchCounts(KERNELS)
# Launches of one variant within a kernel's count: the residual RMSNorm has
# no caller on the model path and runs only where it is asked for; the
# scalar RMSNorm takes rows the vector kernel cannot copy 16 bytes at a
# time (kernels.rmsnorm's ``vector_ok``); every flash launch is either the tensor-core kernel ("mma") or the CUDA-core
# one ("cuda_core"), as kernels.flash_attention's ``variant`` picks.
variant_launches = native.LaunchCounts((
    "rmsnorm/residual", "rmsnorm/scalar", "flash_fwd/mma", "flash_fwd/cuda_core", "flash_bwd_dq/mma",
    "flash_bwd_dq/cuda_core", "flash_bwd_dkv/mma", "flash_bwd_dkv/cuda_core"))

_P, _I = ctypes.c_void_p, ctypes.c_int
native.declare("rmsnorm", {
    "sc_rmsnorm": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_float, _I],
})
native.declare("flash_attention", {
    "sc_flash_fwd": [_P] * 5 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
    "sc_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
    "sc_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
})
native.declare("flash_attention_mma", {
    "sc_flash_fwd_mma": [_P] * 5 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
    "sc_flash_bwd_dq_mma": [_P] * 7 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
    "sc_flash_bwd_dkv_mma": [_P] * 8 + [_I] * 6 + [_P, ctypes.c_float, _I, _I],
})
native.declare("ssd_scan", {
    "sc_ssd_scan": [_P] * 8 + [_I] * 8 + [_P, _I],
})
# dtype codes of the C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set every model kernel's launch counter to 0."""
    launches.reset()
    variant_launches.reset()
