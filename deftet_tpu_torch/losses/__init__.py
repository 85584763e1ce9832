"""Tet regularizers and the surface losses; the frustum box losses (on
no path, for the inventory)."""

from .frustum import (
    FrustumPointNetLoss,
    get_box_corners_3d,
    huber_loss,
    kl_loss,
)
from .geometry import (
    amips_energy,
    amips_energy_soa,
    delta_loss,
    edge_length,
    edge_length_soa,
    gather_tet_soa,
    gather_tet_soa_lattice,
    laplacian_loss,
    neighbor_mean,
    tet_centers_soa,
    tet_volumes,
    volume_variance,
    volume_variance_soa,
)
from .surface import (
    boundary_faces_from_occupancy,
    boundary_info_from_occupancy,
    normal_smoothness_loss,
    normal_smoothness_loss_compacted,
    normal_smoothness_loss_pairs,
    occupancy_bce,
    select_boundary_subset,
    select_boundary_subset_static,
    surface_align_losses,
)

__all__ = [
    "FrustumPointNetLoss",
    "amips_energy",
    "amips_energy_soa",
    "boundary_faces_from_occupancy",
    "boundary_info_from_occupancy",
    "delta_loss",
    "edge_length",
    "edge_length_soa",
    "gather_tet_soa",
    "gather_tet_soa_lattice",
    "get_box_corners_3d",
    "huber_loss",
    "kl_loss",
    "laplacian_loss",
    "neighbor_mean",
    "normal_smoothness_loss",
    "normal_smoothness_loss_compacted",
    "normal_smoothness_loss_pairs",
    "occupancy_bce",
    "select_boundary_subset",
    "select_boundary_subset_static",
    "surface_align_losses",
    "tet_centers_soa",
    "tet_volumes",
    "volume_variance",
    "volume_variance_soa",
]
