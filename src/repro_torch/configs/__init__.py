"""Architecture configs of the port (every family of the reference)."""
from .base import SHAPES, ArchSpec, ShapeSpec  # noqa: F401
from .registry import ARCHS, get_arch  # noqa: F401
