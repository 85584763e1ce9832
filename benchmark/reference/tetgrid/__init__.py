"""Static tetrahedral grid topology (host-side numpy builders)."""

from .grid import TetGrid, build_tet_grid
from .lattice_faces import FaceLattice, build_lattice_topology, \
    face_lattice_info
from .topology import Topology, build_topology

__all__ = ["FaceLattice", "TetGrid", "Topology", "build_lattice_topology",
           "build_tet_grid", "build_topology", "face_lattice_info"]
