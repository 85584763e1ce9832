"""Static tetrahedral grid topology (host-side numpy builders)."""

from .grid import (
    TetGrid,
    boundary_vertex_mask,
    build_tet_grid,
    read_tet_file,
    save_tet_file,
)
from .lattice_faces import (
    FaceLattice,
    LatticeLayout,
    build_lattice_edge_arrays,
    build_lattice_faces,
    build_lattice_topology,
    face_lattice_info,
    face_valid_mask,
    lattice_layout,
)
from .subdivide import delete_tets, subdivide_tets
from .topology import (
    FACE_IDX,
    TET_EDGES,
    Topology,
    build_edge_face_pairs,
    build_face_edge_incidence,
    build_faces,
    build_tet_neighbors,
    build_topology,
    build_vertex_adjacency,
    hull_face_owners,
)

__all__ = [
    "FACE_IDX",
    "FaceLattice",
    "LatticeLayout",
    "TET_EDGES",
    "TetGrid",
    "Topology",
    "boundary_vertex_mask",
    "build_edge_face_pairs",
    "build_face_edge_incidence",
    "build_lattice_edge_arrays",
    "build_lattice_faces",
    "build_lattice_topology",
    "build_faces",
    "build_tet_grid",
    "build_tet_neighbors",
    "build_topology",
    "build_vertex_adjacency",
    "delete_tets",
    "face_lattice_info",
    "face_valid_mask",
    "hull_face_owners",
    "lattice_layout",
    "read_tet_file",
    "save_tet_file",
    "subdivide_tets",
]
