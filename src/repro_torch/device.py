"""Device resolution for the port's entry points.

``None`` means the card: the port is written for CUDA and runs on the CPU
only when a caller asks for it (``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raising ``RuntimeError`` when CUDA is not
    available); anything else is taken as given.

    The check does not initialise the CUDA runtime where it can avoid it:
    ``torch.cuda.device_count`` counts the cards through NVML (falling back
    to the runtime only when NVML fails). ``torch.cuda.is_available`` asks
    the runtime, and a process that has asked it can no longer fork
    children that use the card, as the multi-host pool's hosts must."""
    if device is None:
        if not (torch.cuda.is_initialized() or torch.cuda.device_count() > 0):
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on "
                "the CPU with the plain PyTorch versions of its kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """Which version a kernel wrapper takes for these tensors: True when
    every given tensor lies on the CPU (the plain version), False when every
    one lies on one CUDA device (the kernel). Anything else raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) != 1:
            raise ValueError("inputs lie on different CUDA devices")
        return False
    raise ValueError(f"unsupported device mix {sorted(devs)}: expected cpu or cuda")
