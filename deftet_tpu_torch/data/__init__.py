"""Host-side data: procedural shapes and the occupancy texture."""

from .pipeline import OCC_GRID_EXTENT, occupancy_grid
from .shapes import random_shape

__all__ = ["OCC_GRID_EXTENT", "occupancy_grid", "random_shape"]
