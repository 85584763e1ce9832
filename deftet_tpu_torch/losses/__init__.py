"""Tet regularizers (SoA) and the compacted surface losses."""

from .geometry import (
    amips_energy_soa,
    delta_loss,
    edge_length_soa,
    gather_tet_soa,
    gather_tet_soa_lattice,
    tet_centers_soa,
    volume_variance_soa,
)
from .surface import occupancy_bce, surface_align_losses

__all__ = [
    "amips_energy_soa",
    "delta_loss",
    "edge_length_soa",
    "gather_tet_soa",
    "gather_tet_soa_lattice",
    "occupancy_bce",
    "surface_align_losses",
    "tet_centers_soa",
    "volume_variance_soa",
]
