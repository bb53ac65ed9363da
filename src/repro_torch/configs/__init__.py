from .base import SHAPES, ModelConfig, ShapeSpec, shape_applicable  # noqa: F401
from .registry import ARCHS, all_arch_names, get, smoke_config  # noqa: F401
