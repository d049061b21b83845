from .base import (
    SHAPES,
    SHAPE_BY_NAME,
    InputShape,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RGLRUConfig,
    SSDConfig,
    cell_is_runnable,
    get_config,
    get_smoke_config,
    list_archs,
)
from . import archs as _archs  # noqa: F401  (populates the registry)

__all__ = [
    "SHAPES",
    "SHAPE_BY_NAME",
    "InputShape",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "RGLRUConfig",
    "SSDConfig",
    "cell_is_runnable",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
