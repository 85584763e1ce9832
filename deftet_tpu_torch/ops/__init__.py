"""Device ops: geometry, voxelization, lattice reductions and the three
hand-written kernels (stencil, nearest neighbour, triangle argmin)."""

from ._cuda import launch_counts, reset_launch_counts
from .nearest import nearest_neighbor, sided_squared_distance
from .stencil import lattice_neighbor_mean, stencil_sum
from .tri_distance import point_to_mesh_squared_distance, tri_argmin

__all__ = [
    "lattice_neighbor_mean",
    "launch_counts",
    "nearest_neighbor",
    "point_to_mesh_squared_distance",
    "reset_launch_counts",
    "sided_squared_distance",
    "stencil_sum",
    "tri_argmin",
]
