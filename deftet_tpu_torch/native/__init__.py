"""Native (C++) topology builders, loaded with ctypes (the port's
counterpart of deftet_tpu/native).

``native/topology.cpp`` is compiled by ``g++`` at first use into
``build/native/`` (never at import).  Every builder has a numpy twin in
``tetgrid.topology``, which the tests hold it to.  As in the JAX package,
``build_lattice_topology`` and ``build_grid_statics`` take the native
builders wherever g++ is on the path, the numpy ones otherwise.
"""

from .build import load_library, native_available
from .topology import (
    build_edge_face_pairs_native,
    build_faces_native,
    build_tet_neighbors_native,
    build_topology_native,
    build_vertex_adjacency_native,
    collapse_vertices_native,
)

__all__ = [
    "load_library",
    "native_available",
    "build_faces_native",
    "build_vertex_adjacency_native",
    "build_tet_neighbors_native",
    "build_edge_face_pairs_native",
    "collapse_vertices_native",
    "build_topology_native",
]
