"""Architecture configs of the port (the dense family)."""
from .base import SHAPES, ArchSpec, ShapeSpec  # noqa: F401
from .registry import ARCHS, get_arch  # noqa: F401
