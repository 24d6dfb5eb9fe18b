from .base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from .registry import ArchSpec, arch_names, get_arch, registry

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "ArchSpec", "arch_names", "get_arch", "registry"]
