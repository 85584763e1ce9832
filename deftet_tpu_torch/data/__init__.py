"""Host-side data: procedural shapes, the occupancy texture and the
synthetic dataset."""

from .pipeline import (
    OCC_GRID_EXTENT,
    ShapeDataset,
    batch_iterator,
    build_dataset,
    make_example,
    occupancy_grid,
)
from .shapes import random_shape, shape_family

__all__ = [
    "OCC_GRID_EXTENT",
    "ShapeDataset",
    "batch_iterator",
    "build_dataset",
    "make_example",
    "occupancy_grid",
    "random_shape",
    "shape_family",
]
