from .registry import ARCH_NAMES, get_config, smoke_config
from .shapes import SHAPES, applicable, input_specs, shape_kind

__all__ = ["ARCH_NAMES", "get_config", "smoke_config", "SHAPES",
           "applicable", "input_specs", "shape_kind"]
