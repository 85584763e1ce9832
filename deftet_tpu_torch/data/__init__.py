"""Host-side data: procedural shapes, the occupancy texture, the
synthetic dataset, mesh-directory ingestion and the DISN images."""

from .pipeline import (
    OCC_GRID_EXTENT,
    ShapeDataset,
    batch_iterator,
    build_dataset,
    build_dataset_from_meshes,
    make_example,
    mesh_sdf_points,
    occupancy_grid,
    sample_surface,
)
from .shapes import (
    icosphere,
    make_blob,
    make_box,
    make_ellipsoid,
    make_torus,
    normalize_mesh,
    random_shape,
    shape_family,
)

__all__ = [
    "OCC_GRID_EXTENT",
    "ShapeDataset",
    "batch_iterator",
    "build_dataset",
    "build_dataset_from_meshes",
    "icosphere",
    "make_blob",
    "make_box",
    "make_ellipsoid",
    "make_example",
    "make_torus",
    "mesh_sdf_points",
    "normalize_mesh",
    "occupancy_grid",
    "random_shape",
    "sample_surface",
    "shape_family",
]
