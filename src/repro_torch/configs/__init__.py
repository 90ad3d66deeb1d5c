"""Architecture configs (one module per assigned architecture)."""
from .base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    all_configs,
    get_config,
    load_all,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "all_configs",
    "get_config",
    "load_all",
]
