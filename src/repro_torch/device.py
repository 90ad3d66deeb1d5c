"""Device resolution for the port's entry points.

``None`` means the card: the port is written for CUDA and runs on the CPU
only when a caller asks for it (``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raising ``RuntimeError`` when CUDA is not
    available); anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on "
                "the CPU with the plain PyTorch versions of its kernels"
            )
        return torch.device("cuda")
    return torch.device(device)
