"""Host-side (numpy) topology builders: the parts of
deftet_tpu/tetgrid/topology.py the port uses (face enumeration for the
class tables and the render faces, vertex degrees and padded adjacency,
tet neighbours, hull-face owners)."""

from __future__ import annotations

import numpy as np

# Local face ordering within a tet (first-owner orientation).
FACE_IDX = np.array(
    [[0, 1, 2], [1, 0, 3], [2, 3, 0], [3, 2, 1]], dtype=np.int64
)

TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _group_starts(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)[:-1]])


def build_faces(tets: np.ndarray, n_point: int):
    """Unique triangular faces of a tet list.

    Returns ``(face_fx3, face_tet_fx2, face_slot_fx2, boundary_fx3)``:
    interior faces (two owners) in the first owner's local-face order,
    their owning tets and local slots, and the single-owner hull faces.
    """
    tets = np.asarray(tets, dtype=np.int64)
    flat = tets[:, FACE_IDX].reshape(-1, 3)  # row 4*t + slot
    key = np.sort(flat, axis=1)
    _, inverse, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    if (counts > 2).any():
        raise ValueError("face shared by more than two tets — invalid mesh")
    order = np.argsort(inverse.reshape(-1), kind="stable")
    starts = _group_starts(counts)

    two = counts == 2
    first = order[starts[two]]
    second = order[starts[two] + 1]
    face_fx3 = flat[first].astype(np.int32)
    face_tet_fx2 = np.stack([first // 4, second // 4], axis=1).astype(np.int32)
    face_slot_fx2 = np.stack([first % 4, second % 4], axis=1).astype(np.int32)
    boundary_fx3 = flat[order[starts[counts == 1]]].astype(np.int32)
    return face_fx3, face_tet_fx2, face_slot_fx2, boundary_fx3


def vertex_degree(tets: np.ndarray, n_point: int) -> np.ndarray:
    """(N,) int32 number of distinct tet-edge neighbours per vertex (the
    row normalizer of the vertex adjacency)."""
    tets = np.asarray(tets, dtype=np.int64)
    e = tets[:, TET_EDGES].reshape(-1, 2)
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    uniq = np.unique(e[:, 0] * n_point + e[:, 1])
    return np.bincount(uniq // n_point, minlength=n_point).astype(np.int32)


def hull_face_owners(
    tets: np.ndarray, hull_fx3: np.ndarray, n_point: int
) -> np.ndarray:
    """Owning tet of each single-owner (hull) face, by matching the face's
    sorted vertex key against every tet's local faces."""
    tets = np.asarray(tets, dtype=np.int64)
    tris = tets[:, FACE_IDX].reshape(-1, 3)
    n = np.int64(n_point)

    def encode(f):
        k = np.sort(np.asarray(f, dtype=np.int64), axis=1)
        return (k[:, 0] * n + k[:, 1]) * n + k[:, 2]

    keys = encode(tris)
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(keys[order], encode(hull_fx3))
    return (order[pos] // 4).astype(np.int32)


def build_vertex_adjacency(tets: np.ndarray, n_point: int):
    """Vertex adjacency as padded neighbour lists: (idx (N, M) int32,
    mask (N, M) float32, deg (N,) int32), so that the row-normalized
    ``adj @ x`` is ``(x[idx] * mask[..., None]).sum(-2) / deg``."""
    tets = np.asarray(tets, dtype=np.int64)
    e = tets[:, TET_EDGES].reshape(-1, 2)
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    uniq = np.unique(e[:, 0] * n_point + e[:, 1])
    src = (uniq // n_point).astype(np.int64)
    dst = (uniq % n_point).astype(np.int64)
    deg = np.bincount(src, minlength=n_point)
    max_deg = int(deg.max()) if deg.size else 0
    idx = np.zeros((n_point, max_deg), dtype=np.int32)
    mask = np.zeros((n_point, max_deg), dtype=np.float32)
    pos = np.arange(src.shape[0]) - _group_starts(deg)[src]
    idx[src, pos] = dst
    mask[src, pos] = 1.0
    return idx, mask, deg.astype(np.int32)


def build_tet_neighbors(
    face_tet_fx2: np.ndarray, face_slot_fx2: np.ndarray, n_tets: int
) -> np.ndarray:
    """(T, 4) neighbour tet index per local face slot, -1 at the hull."""
    nbr = np.full((n_tets, 4), -1, dtype=np.int32)
    nbr[face_tet_fx2[:, 0], face_slot_fx2[:, 0]] = face_tet_fx2[:, 1]
    nbr[face_tet_fx2[:, 1], face_slot_fx2[:, 1]] = face_tet_fx2[:, 0]
    return nbr
