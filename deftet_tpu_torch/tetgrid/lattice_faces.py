"""Class-major interior faces of the regular Kuhn tet grid (numpy; copy of
deftet_tpu/tetgrid/lattice_faces.py trimmed to what the train step uses).

Every interior face of the regular grid is one of 12 translation classes
(6 inside a cell, 6 across a cell wall).  Faces are ordered class-major,
``face = class * r^3 + cell``, so the boundary test and the per-edge
normal-loss sums are shifted slices of ``(B, 6|12, r, r, r)`` arrays
(``ops.lattice``).

Layout contract:

* the face axis has ``12 r^3`` slots; slot ``c * r^3 + cell`` is the
  class-``c`` face anchored at ``cell = i r^2 + j r + k``;
* a slot is valid iff the partner cell ``cell + delta_c`` is on the grid;
  an invalid slot holds the anchor tet's hull face with
  ``face_tet = (owner, owner)``, so it is never a boundary face;
* ``face_fx3`` keeps the first (smaller-index) owner's local-face order.

The class tables are derived from a small probe grid, asserting
translation invariance.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .grid import build_tet_grid
from .topology import build_faces, vertex_degree

#: The 7 edge direction classes of the Kuhn lattice, as (di, dj, dk) from
#: the edge's min-corner anchor vertex.
EDGE_DIRS = (
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1),
    (1, 1, 1),
)

_PROBE_RES = 4


@dataclasses.dataclass(frozen=True)
class FaceClass:
    """One translation class of interior faces: first/second owner tet
    type and local slot, the partner cell offset ``delta`` and the face's
    vertex offsets ``voff`` from the anchor cell origin."""

    first_type: int
    first_slot: int
    second_type: int
    second_slot: int
    delta: tuple
    voff: tuple


def _cell_coords(lin: np.ndarray, r: int) -> np.ndarray:
    return np.stack([lin // (r * r), (lin // r) % r, lin % r], axis=-1)


def _vert_coords(v: np.ndarray, n: int) -> np.ndarray:
    return np.stack([v // (n * n), (v // n) % n, v % n], axis=-1)


def _probe_faces():
    r = _PROBE_RES
    g = build_tet_grid(r)
    face_fx3, face_tet, face_slot, _ = build_faces(g.tets, g.n_vertices)
    ta = face_tet[:, 0].astype(np.int64)
    sig = np.stack([ta // r**3, face_slot[:, 0]], axis=-1)
    uniq, inv = np.unique(sig, axis=0, return_inverse=True)
    return r, face_fx3, face_tet, face_slot, uniq, inv.reshape(-1)


@functools.lru_cache(maxsize=1)
def face_class_table() -> tuple:
    """The 12 FaceClass entries, ordered by (first_type, first_slot)."""
    r, face_fx3, face_tet, face_slot, uniq, inv = _probe_faces()
    n = r + 1
    ta = face_tet[:, 0].astype(np.int64)
    tb = face_tet[:, 1].astype(np.int64)
    if not (ta < tb).all():
        raise AssertionError("first owner must be the smaller tet index")
    if uniq.shape[0] != 12:
        raise AssertionError(f"expected 12 face classes, got {uniq.shape}")
    ca = _cell_coords(ta % r**3, r)
    cb = _cell_coords(tb % r**3, r)
    classes = []
    for ci in range(12):
        rows = np.where(inv == ci)[0]
        delta = cb[rows] - ca[rows]
        voff = (
            _vert_coords(face_fx3[rows].astype(np.int64), n)
            - ca[rows][:, None, :]
        )
        second = np.stack([tb // r**3, face_slot[:, 1]], axis=-1)[rows]
        if not ((delta == delta[0]).all() and (voff == voff[0]).all()
                and (second == second[0]).all()):
            raise AssertionError("face class not translation-invariant")
        classes.append(
            FaceClass(
                first_type=int(uniq[ci, 0]),
                first_slot=int(uniq[ci, 1]),
                second_type=int(second[0, 0]),
                second_slot=int(second[0, 1]),
                delta=tuple(int(x) for x in delta[0]),
                voff=tuple(
                    tuple(int(x) for x in voff[0, k]) for k in range(3)
                ),
            )
        )
    return tuple(classes)


@functools.lru_cache(maxsize=1)
def edge_class_table() -> tuple:
    """Per edge-direction class: ``(face_class, (di, dj, dk))`` entries —
    the edge anchored at vertex ``m`` is an edge of the class face anchored
    at cell ``m + (di, dj, dk)`` when that face slot exists."""
    r, face_fx3, face_tet, _, _, fclass = _probe_faces()
    n = r + 1
    ca = _cell_coords(face_tet[:, 0].astype(np.int64) % r**3, r)
    edges = np.stack(
        [face_fx3[:, [0, 1]], face_fx3[:, [1, 2]], face_fx3[:, [2, 0]]],
        axis=1,
    ).reshape(-1, 2).astype(np.int64)
    owner_face = np.repeat(np.arange(face_fx3.shape[0]), 3)
    pl = _vert_coords(np.minimum(edges[:, 0], edges[:, 1]), n)
    ph = _vert_coords(np.maximum(edges[:, 0], edges[:, 1]), n)
    anchor = np.minimum(pl, ph)
    dv = np.abs(ph - pl)
    dir_id = {d: i for i, d in enumerate(EDGE_DIRS)}
    tables = [set() for _ in EDGE_DIRS]
    interior = (anchor >= 1).all(1) & (anchor <= r - 2).all(1)
    for i in np.where(interior)[0]:
        d = dir_id[tuple(int(x) for x in dv[i])]
        tables[d].add(
            (
                int(fclass[owner_face[i]]),
                tuple(int(x) for x in (ca[owner_face[i]] - anchor[i])),
            )
        )
    out = tuple(tuple(sorted(t)) for t in tables)
    if not all(out):
        raise AssertionError("an edge class was unseen in the probe grid")
    return out


def build_lattice_faces(r: int):
    """Class-major padded interior faces of a res-``r`` Kuhn grid.

    Returns ``(face_fx3 (12r^3, 3) int32, face_tet_fx2 (12r^3, 2) int32,
    valid (12r^3,) bool)``; invalid slots carry the anchor tet's hull face
    with ``face_tet = (anchor, anchor)``.
    """
    classes = face_class_table()
    n = r + 1
    r3 = r**3
    ii, jj, kk = np.meshgrid(
        np.arange(r), np.arange(r), np.arange(r), indexing="ij"
    )
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    cell_lin = cells[:, 0] * r * r + cells[:, 1] * r + cells[:, 2]

    face_fx3 = np.empty((12 * r3, 3), np.int32)
    face_tet = np.empty((12 * r3, 2), np.int32)
    valid = np.empty(12 * r3, bool)
    for c, fc in enumerate(classes):
        sl = slice(c * r3, (c + 1) * r3)
        pts = cells[:, None, :] + np.asarray(fc.voff, np.int64)[None]
        face_fx3[sl] = (
            pts[..., 0] * n * n + pts[..., 1] * n + pts[..., 2]
        ).astype(np.int32)
        ta = fc.first_type * r3 + cell_lin
        partner = cells + np.asarray(fc.delta, np.int64)
        v = ((partner >= 0) & (partner < r)).all(axis=1)
        tb_cell = partner[:, 0] * r * r + partner[:, 1] * r + partner[:, 2]
        face_tet[sl, 0] = ta
        face_tet[sl, 1] = np.where(v, fc.second_type * r3 + tb_cell, ta)
        valid[sl] = v
    return face_fx3, face_tet, valid


@dataclasses.dataclass(frozen=True)
class FaceLattice:
    """Static lattice-class info (hashable nested tuples of ints)."""

    res: int
    classes: tuple
    edge_incidence: tuple


def face_lattice_info(grid) -> FaceLattice | None:
    """FaceLattice for a regular Kuhn grid, else None."""
    from ..train.statics import lattice_tet_offsets

    if grid.resolution < 2 or lattice_tet_offsets(grid) is None:
        return None
    return FaceLattice(
        res=int(grid.resolution),
        classes=face_class_table(),
        edge_incidence=edge_class_table(),
    )


@dataclasses.dataclass
class LatticeTopology:
    """The topology arrays the lattice train step reads."""

    tet_tx4: np.ndarray       # (T, 4) int32
    face_fx3: np.ndarray      # (12 r^3, 3) int32 class-major faces
    face_tet_fx2: np.ndarray  # (12 r^3, 2) int32 owners (self-paired if invalid)
    vert_degree: np.ndarray   # (N,) int32


def build_lattice_topology(grid) -> LatticeTopology | None:
    """Class-major lattice topology, or None for a non-lattice grid."""
    if face_lattice_info(grid) is None:
        return None
    face_v, face_tet, _ = build_lattice_faces(grid.resolution)
    tets = np.asarray(grid.tets, np.int32)
    return LatticeTopology(
        tet_tx4=tets,
        face_fx3=face_v,
        face_tet_fx2=face_tet,
        vert_degree=vertex_degree(tets, grid.n_vertices),
    )
