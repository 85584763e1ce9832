"""Host-side (numpy) topology builders (copy of
deftet_tpu/tetgrid/topology.py): interior and hull faces, the padded
vertex adjacency and degrees, tet neighbours, hull-face owners, and the gather
tables of the general-grid train step — edge -> face incidence, face ->
edge ids, vertex -> face-corner and vertex -> tet-corner incidence —
gathered into one ``Topology``."""

from __future__ import annotations

import dataclasses

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


def _face_edge_keys(face_fx3: np.ndarray, n_point: int) -> np.ndarray:
    """(3F,) undirected edge key of each face edge (ab, bc, ca), face-major."""
    face_fx3 = np.asarray(face_fx3, dtype=np.int64)
    edges = np.stack(
        [face_fx3[:, [0, 1]], face_fx3[:, [1, 2]], face_fx3[:, [2, 0]]],
        axis=1,
    ).reshape(-1, 2)
    return edges.min(axis=1) * n_point + edges.max(axis=1)


def build_face_edge_incidence(face_fx3: np.ndarray, n_point: int):
    """Interior faces grouped by shared undirected edge: (edge_face_idx
    (E, M) int32 padded with 0, edge_face_mask (E, M) float32)."""
    key = _face_edge_keys(face_fx3, n_point)
    _, inverse, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    starts = _group_starts(counts)
    n_edges = counts.shape[0]
    max_m = int(counts.max()) if counts.size else 0
    idx = np.zeros((n_edges, max_m), dtype=np.int32)
    mask = np.zeros((n_edges, max_m), dtype=np.float32)
    grp = inverse[order]
    pos = np.arange(order.shape[0]) - starts[grp]
    idx[grp, pos] = (order // 3).astype(np.int32)
    mask[grp, pos] = 1.0
    return idx, mask


def build_edge_entries(face_fx3: np.ndarray, n_point: int):
    """(face, edge) incidence entries sorted by edge id: (entry_face (3F,)
    int32, entry_edge (3F,) int32 ascending, n_edges)."""
    key = _face_edge_keys(face_fx3, n_point)
    uniq, inverse = np.unique(key, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    entry_face = (order // 3).astype(np.int32)
    entry_edge = inverse[order].astype(np.int32)
    return entry_face, entry_edge, int(uniq.size)


def build_face_edge_ids(face_fx3: np.ndarray, n_point: int) -> np.ndarray:
    """(F, 3) edge id of each face's three edges (build_edge_entries'
    numbering): the backward of a per-edge sum over faces gathers the
    per-edge cotangents at these ids."""
    _, inverse = np.unique(_face_edge_keys(face_fx3, n_point),
                           return_inverse=True)
    return inverse.reshape(-1, 3).astype(np.int32)


def _corner_incidence(corners_kxc: np.ndarray, n_point: int):
    """Vertex -> corner slots of a k-major flat corner list (slot = k * C +
    c for corner k of cell c), padded: (inc_idx (N, M) int32, inc_mask
    (N, M) float32)."""
    corners_kxc = np.asarray(corners_kxc, dtype=np.int64)
    verts_flat = corners_kxc.reshape(-1)
    order = np.argsort(verts_flat, kind="stable")
    sorted_v = verts_flat[order]
    counts = np.bincount(sorted_v, minlength=n_point)
    max_m = int(counts.max()) if counts.size and corners_kxc.size else 1
    inc_idx = np.zeros((n_point, max_m), np.int32)
    inc_mask = np.zeros((n_point, max_m), np.float32)
    starts = _group_starts(counts)
    pos = np.arange(order.shape[0]) - starts[sorted_v]
    inc_idx[sorted_v, pos] = order.astype(np.int32)
    inc_mask[sorted_v, pos] = 1.0
    return inc_idx, inc_mask


def build_vertex_face_incidence(face_fx3: np.ndarray, n_point: int):
    """Vertex -> incident face-corner slots (slot = k * F + f), the
    transpose of the k-major face-corner gather: its backward becomes a
    padded gather instead of a scatter-add with duplicate indices."""
    return _corner_incidence(np.asarray(face_fx3).T, n_point)


def build_vertex_tet_incidence(tets_tx4: np.ndarray, n_point: int):
    """Vertex -> incident tet-corner slots (slot = k * T + t), the
    transpose of the k-major tet-corner gather."""
    return _corner_incidence(np.asarray(tets_tx4).T, n_point)


def build_edge_face_pairs(face_fx3: np.ndarray, n_point: int):
    """Unordered pairs of interior faces sharing an undirected edge:
    (pair_a (P,), pair_b (P,)) int32, the oracle's input of the normal
    term."""
    idx, mask = build_face_edge_incidence(face_fx3, n_point)
    pairs_a, pairs_b = [], []
    m = idx.shape[1]
    for i in range(m):
        for j in range(i + 1, m):
            both = (mask[:, i] > 0) & (mask[:, j] > 0)
            pairs_a.append(idx[both, i])
            pairs_b.append(idx[both, j])
    if pairs_a:
        return (np.concatenate(pairs_a).astype(np.int32),
                np.concatenate(pairs_b).astype(np.int32))
    return np.zeros(0, np.int32), np.zeros(0, np.int32)


#: The Topology fields derived from the face list (built on request on
#: the lattice: only the uncompacted normal term reads them).
FACE_ARRAYS = ("edge_face_idx", "edge_face_mask", "edge_pair_fa",
               "edge_pair_fb", "edge_entry_face", "edge_entry_edge",
               "face_edge_ids", "vert_face_inc_idx", "vert_face_inc_mask")


@dataclasses.dataclass
class Topology:
    """All static topology of a tet grid, as dense numpy arrays.  On the
    lattice the FACE_ARRAYS fields may be None (not built)."""

    n_vertices: int
    n_tets: int
    tet_tx4: np.ndarray          # (T, 4) int32
    face_fx3: np.ndarray         # (F, 3) int32 interior faces
    face_tet_fx2: np.ndarray     # (F, 2) int32
    face_slot_fx2: np.ndarray    # (F, 2) int32
    hull_face_hx3: np.ndarray    # (H, 3) int32 grid-boundary faces
    vert_adj_idx: np.ndarray     # (N, M) int32
    vert_adj_mask: np.ndarray    # (N, M) float32
    vert_degree: np.ndarray      # (N,) int32
    tet_neighbor_tx4: np.ndarray  # (T, 4) int32, -1 at the hull
    edge_face_idx: np.ndarray    # (E, Me) int32
    edge_face_mask: np.ndarray   # (E, Me) float32
    edge_pair_fa: np.ndarray     # (P,) int32 faces sharing an edge, side a
    edge_pair_fb: np.ndarray     # (P,) int32 side b
    edge_entry_face: np.ndarray  # (3F,) int32 incidence entries...
    edge_entry_edge: np.ndarray  # (3F,) int32 ...sorted by edge id
    face_edge_ids: np.ndarray    # (F, 3) int32 edge id per face edge
    vert_face_inc_idx: np.ndarray   # (N, M) int32 face-corner slots
    vert_face_inc_mask: np.ndarray  # (N, M) float32
    vert_tet_inc_idx: np.ndarray    # (N, Mt) int32 tet-corner slots
    vert_tet_inc_mask: np.ndarray   # (N, Mt) float32

    def save(self, path: str) -> None:
        """``np.savez_compressed`` of every field that was built."""
        np.savez_compressed(path, **{k: v for k, v in
                                     dataclasses.asdict(self).items()
                                     if v is not None})

    @classmethod
    def load(cls, path: str) -> "Topology":
        d = np.load(path)
        return cls(
            n_vertices=int(d["n_vertices"]),
            n_tets=int(d["n_tets"]),
            **{f.name: d[f.name] if f.name in d else None
               for f in dataclasses.fields(cls)
               if f.name not in ("n_vertices", "n_tets")},
        )


def build_topology(tets: np.ndarray, n_point: int) -> Topology:
    """Every array of ``Topology`` for a general tet list."""
    tets = np.asarray(tets)
    face_fx3, face_tet_fx2, face_slot_fx2, hull = build_faces(tets, n_point)
    vai, vam, deg = build_vertex_adjacency(tets, n_point)
    nbr = build_tet_neighbors(face_tet_fx2, face_slot_fx2, tets.shape[0])
    efi, efm = build_face_edge_incidence(face_fx3, n_point)
    pa, pb = build_edge_face_pairs(face_fx3, n_point)
    eef, eee, _ = build_edge_entries(face_fx3, n_point)
    fei = build_face_edge_ids(face_fx3, n_point)
    vfi, vfm = build_vertex_face_incidence(face_fx3, n_point)
    vti, vtm = build_vertex_tet_incidence(tets, n_point)
    return Topology(
        n_vertices=int(n_point), n_tets=int(tets.shape[0]),
        tet_tx4=tets.astype(np.int32), face_fx3=face_fx3,
        face_tet_fx2=face_tet_fx2, face_slot_fx2=face_slot_fx2,
        hull_face_hx3=hull, vert_adj_idx=vai, vert_adj_mask=vam,
        vert_degree=deg, tet_neighbor_tx4=nbr, edge_face_idx=efi,
        edge_face_mask=efm, edge_pair_fa=pa, edge_pair_fb=pb,
        edge_entry_face=eef, edge_entry_edge=eee, face_edge_ids=fei,
        vert_face_inc_idx=vfi, vert_face_inc_mask=vfm,
        vert_tet_inc_idx=vti, vert_tet_inc_mask=vtm,
    )
