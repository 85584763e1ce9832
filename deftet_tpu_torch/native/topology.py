"""ctypes wrappers over native/topology.cpp (the port's counterpart of
deftet_tpu/native/topology.py).

Each builder returns what its numpy twin in ``tetgrid.topology`` returns,
in the same order, except the edge-face pairs: the same set of pairs,
listed edge by edge.  Without a compiler every wrapper raises: none falls
back to numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..tetgrid.topology import (
    Topology,
    build_edge_entries,
    build_face_edge_ids,
    build_face_edge_incidence,
    build_vertex_face_incidence,
    build_vertex_tet_incidence,
)
from .build import load_library

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)

# C function -> (return type, argument types)
_SIGNATURES = {
    "build_faces": (ctypes.c_int, [_i32p, _i64, _i64, _i32p, _i32p, _i32p,
                                   _i32p, _i64p, _i64p]),
    "vertex_adjacency_max_degree": (_i64, [_i32p, _i64, _i64]),
    "build_vertex_adjacency": (None, [_i32p, _i64, _i64, _i64, _i32p, _f32p,
                                      _i32p]),
    "build_tet_neighbors": (None, [_i32p, _i32p, _i64, _i64, _i32p]),
    "build_edge_face_pairs": (_i64, [_i32p, _i64, _i64, ctypes.c_void_p,
                                     ctypes.c_void_p]),
    "collapse_vertices": (_i64, [_f64p, _i64, ctypes.c_double, _i32p,
                                 _f64p]),
}


def _indices(a: np.ndarray, cols: int, limit: int, what: str) -> np.ndarray:
    """``a`` as a C-contiguous (n, cols) int32 array of indices in
    [0, limit): the C code reads and writes through them unchecked."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"{what}: shape {a.shape}, expected (n, {cols})")
    if a.size and (a.min() < 0 or a.max() >= limit):
        raise ValueError(f"{what}: indices outside [0, {limit})")
    return a


def _lib():
    lib = load_library("topology")
    if lib is None:
        raise RuntimeError("native topology library unavailable (no g++)")
    if not getattr(lib, "_sigs_set", False):
        for fn_name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib._sigs_set = True
    return lib


def build_faces_native(tets: np.ndarray, n_point: int):
    """Native twin of ``tetgrid.topology.build_faces``: (face_fx3,
    face_tet_fx2, face_slot_fx2, hull_hx3), int32."""
    lib = _lib()
    tets = _indices(tets, 4, n_point, "tets")
    t = tets.shape[0]
    face_v = np.empty((2 * t + 4, 3), np.int32)
    face_tet = np.empty((2 * t + 4, 2), np.int32)
    face_slot = np.empty((2 * t + 4, 2), np.int32)
    hull_v = np.empty((4 * t + 4, 3), np.int32)
    ni, nh = _i64(0), _i64(0)
    rc = lib.build_faces(tets, t, n_point, face_v, face_tet, face_slot,
                         hull_v, ctypes.byref(ni), ctypes.byref(nh))
    if rc != 0:
        raise ValueError("face shared by more than two tets — invalid mesh")
    ni, nh = ni.value, nh.value
    return (face_v[:ni].copy(), face_tet[:ni].copy(), face_slot[:ni].copy(),
            hull_v[:nh].copy())


def build_vertex_adjacency_native(tets: np.ndarray, n_point: int):
    """Native twin of ``build_vertex_adjacency``: (idx (N, M) int32, mask
    (N, M) float32, degree (N,) int32)."""
    lib = _lib()
    tets = _indices(tets, 4, n_point, "tets")
    t = tets.shape[0]
    max_deg = max(int(lib.vertex_adjacency_max_degree(tets, t, n_point)), 1)
    idx = np.zeros((n_point, max_deg), np.int32)
    mask = np.zeros((n_point, max_deg), np.float32)
    deg = np.zeros((n_point,), np.int32)
    lib.build_vertex_adjacency(tets, t, n_point, max_deg, idx, mask, deg)
    return idx, mask, deg


def build_tet_neighbors_native(face_tet: np.ndarray, face_slot: np.ndarray,
                               n_tets: int):
    """Native twin of ``build_tet_neighbors``: (T, 4) int32, -1 at the
    hull."""
    lib = _lib()
    face_tet = _indices(face_tet, 2, n_tets, "face_tet")
    face_slot = _indices(face_slot, 2, 4, "face_slot")
    if face_slot.shape != face_tet.shape:
        raise ValueError("face_slot and face_tet differ in shape")
    nbr = np.empty((n_tets, 4), np.int32)
    lib.build_tet_neighbors(face_tet, face_slot, face_tet.shape[0], n_tets,
                            nbr)
    return nbr


def build_edge_face_pairs_native(face_v: np.ndarray, n_point: int):
    """The pairs of ``build_edge_face_pairs`` (pair_a, pair_b) int32, as a
    set: listed by edge key, then by face, where numpy lists them by
    incidence column."""
    lib = _lib()
    face_v = _indices(face_v, 3, n_point, "face_v")
    f = face_v.shape[0]
    count = int(lib.build_edge_face_pairs(face_v, f, n_point, None, None))
    pa = np.empty((count,), np.int32)
    pb = np.empty((count,), np.int32)
    if count:
        lib.build_edge_face_pairs(face_v, f, n_point,
                                  pa.ctypes.data_as(ctypes.c_void_p),
                                  pb.ctypes.data_as(ctypes.c_void_p))
    return pa, pb


def collapse_vertices_native(verts: np.ndarray, decimals: int = 5):
    """Vertices deduplicated by their coordinates rounded to ``decimals``:
    (unique (U, 3) float64 in order of first rounded key, remap (N,) int32
    old -> new); each group keeps its lowest-index vertex."""
    lib = _lib()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    if verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"verts: shape {verts.shape}, expected (n, 3)")
    n = verts.shape[0]
    remap = np.empty((n,), np.int32)
    out = np.empty((n, 3), np.float64)
    n_unique = int(lib.collapse_vertices(verts, n, float(10 ** decimals),
                                         remap, out))
    return out[:n_unique].copy(), remap


def build_topology_native(tets: np.ndarray, n_point: int,
                          with_incidence: bool = True) -> Topology:
    """``tetgrid.topology.build_topology`` with the faces, the vertex
    adjacency, the tet neighbours and the edge-face pairs built natively,
    the gather tables by the numpy builders.  ``with_incidence=False``
    leaves the edge -> face incidence (the slowest numpy builder) empty:
    (0, 1) arrays."""
    face_v, face_tet, face_slot, hull = build_faces_native(tets, n_point)
    idx, mask, deg = build_vertex_adjacency_native(tets, n_point)
    nbr = build_tet_neighbors_native(face_tet, face_slot, tets.shape[0])
    pa, pb = build_edge_face_pairs_native(face_v, n_point)
    eef, eee, _ = build_edge_entries(face_v, n_point)
    fei = build_face_edge_ids(face_v, n_point)
    vfi, vfm = build_vertex_face_incidence(face_v, n_point)
    vti, vtm = build_vertex_tet_incidence(tets, n_point)
    if with_incidence:
        efi, efm = build_face_edge_incidence(face_v, n_point)
    else:
        efi = np.zeros((0, 1), np.int32)
        efm = np.zeros((0, 1), np.float32)
    return Topology(
        n_vertices=int(n_point), n_tets=int(tets.shape[0]),
        tet_tx4=np.ascontiguousarray(tets, dtype=np.int32), face_fx3=face_v,
        face_tet_fx2=face_tet, face_slot_fx2=face_slot, hull_face_hx3=hull,
        vert_adj_idx=idx, vert_adj_mask=mask, vert_degree=deg,
        tet_neighbor_tx4=nbr, edge_face_idx=efi, edge_face_mask=efm,
        edge_pair_fa=pa, edge_pair_fb=pb, edge_entry_face=eef,
        edge_entry_edge=eee, face_edge_ids=fei, vert_face_inc_idx=vfi,
        vert_face_inc_mask=vfm, vert_tet_inc_idx=vti, vert_tet_inc_mask=vtm,
    )
