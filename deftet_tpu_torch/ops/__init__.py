"""Device ops: geometry, voxelization, lattice reductions, the wrappers of
five of the six hand-written kernels (``stencil``, ``nearest``,
``tri_distance``, ``point_tet``, ``grid_probe``; the sixth, ``raster_hit``,
is wrapped in ``render/raster.py``) and the PointNet sampling ops
(``ops.sampling``, on no path)."""

from ._cuda import launch_counts, reset_launch_counts
from .check_sign import check_sign
from .geometry import (
    det3x3,
    face_normals,
    gather_tet_vertices,
    safe_inverse3x3,
    tet_rest_inverse,
)
from .nearest import nearest_neighbor, sided_squared_distance
from .point_tet import points_in_tets, points_in_tets_soa
from .sampling import (
    ball_query,
    furthest_point_sample,
    gather_points,
    grouping,
    logits_mask,
    three_nn_interpolate,
)
from .stencil import lattice_neighbor_mean, stencil_sum
from .tri_distance import point_to_mesh_squared_distance, tri_argmin
from .voxelize import (
    avg_voxelize,
    occupancy_from_grid,
    occupancy_from_grid_soa,
    trilinear_devoxelize,
)

__all__ = [
    "avg_voxelize",
    "ball_query",
    "check_sign",
    "det3x3",
    "face_normals",
    "furthest_point_sample",
    "gather_points",
    "gather_tet_vertices",
    "grouping",
    "lattice_neighbor_mean",
    "launch_counts",
    "logits_mask",
    "nearest_neighbor",
    "occupancy_from_grid",
    "occupancy_from_grid_soa",
    "point_to_mesh_squared_distance",
    "points_in_tets",
    "points_in_tets_soa",
    "reset_launch_counts",
    "safe_inverse3x3",
    "sided_squared_distance",
    "stencil_sum",
    "tet_rest_inverse",
    "three_nn_interpolate",
    "tri_argmin",
    "trilinear_devoxelize",
]
