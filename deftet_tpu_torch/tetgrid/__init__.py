"""Static tetrahedral grid topology (host-side numpy builders)."""

from .grid import TetGrid, build_tet_grid, read_tet_file, save_tet_file
from .lattice_faces import (
    FaceLattice,
    build_lattice_faces,
    build_lattice_topology,
    face_lattice_info,
)
from .subdivide import delete_tets, subdivide_tets
from .topology import (
    build_faces,
    build_tet_neighbors,
    build_vertex_adjacency,
    hull_face_owners,
)

__all__ = [
    "FaceLattice",
    "TetGrid",
    "build_lattice_faces",
    "build_lattice_topology",
    "build_faces",
    "build_tet_grid",
    "build_tet_neighbors",
    "build_vertex_adjacency",
    "delete_tets",
    "face_lattice_info",
    "hull_face_owners",
    "read_tet_file",
    "save_tet_file",
    "subdivide_tets",
]
