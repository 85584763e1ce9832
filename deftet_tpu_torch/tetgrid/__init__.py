"""Static tetrahedral grid topology (host-side numpy builders)."""

from .grid import TetGrid, build_tet_grid
from .lattice_faces import (
    FaceLattice,
    build_lattice_faces,
    build_lattice_topology,
    face_lattice_info,
)

__all__ = [
    "FaceLattice",
    "TetGrid",
    "build_lattice_faces",
    "build_lattice_topology",
    "build_tet_grid",
    "face_lattice_info",
]
