"""Architecture configs of the port (every family of the reference)."""
from .base import (SHAPES, ArchSpec, ShapeSpec, cache_specs,  # noqa: F401
                   input_specs)
from .registry import ARCHS, all_cells, get_arch  # noqa: F401
