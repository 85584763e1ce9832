"""Class-major interior faces of the regular Kuhn tet grid (numpy; copy of
deftet_tpu/tetgrid/lattice_faces.py).

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

``lattice_layout`` is the one place that decides whether a grid is the
regular lattice; the statics carry its answer (``GridStatics.lattice``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np

from .grid import _CUBE_TETS, build_tet_grid
from .topology import (
    FACE_ARRAYS,
    FACE_IDX,
    TET_EDGES,
    Topology,
    build_edge_face_pairs,
    build_faces,
    build_tet_neighbors,
    build_vertex_adjacency,
    build_vertex_face_incidence,
    build_vertex_tet_incidence,
)

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
    face_slot_fx2 (12r^3, 2) int32, valid (12r^3,) bool, hull_face_hx3
    (H, 3) int32)``; invalid slots carry the anchor tet's hull face with
    ``face_tet = (anchor, anchor)``.  The hull is the invalid slots' faces
    plus the second-owner-side faces whose anchor cell is off the grid.
    """
    classes = face_class_table()
    n = r + 1
    r3 = r**3
    ii, jj, kk = np.meshgrid(
        np.arange(r), np.arange(r), np.arange(r), indexing="ij"
    )
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    cell_lin = cells[:, 0] * r * r + cells[:, 1] * r + cells[:, 2]

    def vert_lin(pts):
        return pts[..., 0] * n * n + pts[..., 1] * n + pts[..., 2]

    face_fx3 = np.empty((12 * r3, 3), np.int32)
    face_tet = np.empty((12 * r3, 2), np.int32)
    face_slot = np.empty((12 * r3, 2), np.int32)
    valid = np.empty(12 * r3, bool)
    hull_parts = []
    for c, fc in enumerate(classes):
        sl = slice(c * r3, (c + 1) * r3)
        pts = cells[:, None, :] + np.asarray(fc.voff, np.int64)[None]
        face_fx3[sl] = vert_lin(pts).astype(np.int32)
        ta = fc.first_type * r3 + cell_lin
        partner = cells + np.asarray(fc.delta, np.int64)
        v = ((partner >= 0) & (partner < r)).all(axis=1)
        tb_cell = partner[:, 0] * r * r + partner[:, 1] * r + partner[:, 2]
        face_tet[sl, 0] = ta
        face_tet[sl, 1] = np.where(v, fc.second_type * r3 + tb_cell, ta)
        face_slot[sl, 0] = fc.first_slot
        face_slot[sl, 1] = np.where(v, fc.second_slot, fc.first_slot)
        valid[sl] = v
        hull_parts.append(face_fx3[sl][~v])

    # the class face seen from the partner tet where the anchor cell would
    # be off the grid, from the partner tet's corner offsets and local slot
    corner_off = np.array(
        [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.int64)
    tet_corner_off = corner_off[_CUBE_TETS]  # (6, 4, 3)
    for fc in classes:
        if fc.delta == (0, 0, 0):
            continue
        anchor = cells - np.asarray(fc.delta, np.int64)
        off = ~((anchor >= 0) & (anchor < r)).all(axis=1)
        tri_off = tet_corner_off[fc.second_type][FACE_IDX[fc.second_slot]]
        hull_parts.append(
            vert_lin(cells[off][:, None, :] + tri_off[None]).astype(np.int32))
    hull = (np.concatenate(hull_parts, axis=0) if hull_parts
            else np.zeros((0, 3), np.int32))
    return face_fx3, face_tet, face_slot, valid, hull


def face_valid_mask(r: int) -> np.ndarray:
    """(12, r, r, r) bool: the class-major face slots whose partner cell
    lies on the grid."""
    out = np.empty((12, r, r, r), bool)
    idx = np.arange(r)
    for c, fc in enumerate(face_class_table()):
        m = np.ones((r, r, r), bool)
        for ax, d in enumerate(fc.delta):
            shape = [1, 1, 1]
            shape[ax] = r
            m &= ((idx + d >= 0) & (idx + d < r)).reshape(shape)
        out[c] = m
    return out


def build_lattice_edge_arrays(r: int):
    """Edge -> face incidence and face -> edge ids of the class-major
    layout by arithmetic on the class tables (no sort over the 3F edge
    keys).  Edges are numbered ``ec * (r+1)^3 + lin(anchor)`` over the 7
    direction classes and the anchor vertices, so some edge rows are all
    padding; their sums are inert.  Returns ``(edge_face_idx (7(r+1)^3,
    Me) int32, edge_face_mask float32, face_edge_ids (12 r^3, 3) int32)``:
    a mask is 1 wherever the incident face slot exists (its cell on the
    grid), hull-padded slots included, as the generic builder lists them
    on the padded face list."""
    einc = edge_class_table()
    r3 = r**3
    n_anchor = (r + 1) ** 3
    ai, aj, ak = np.meshgrid(
        np.arange(r + 1), np.arange(r + 1), np.arange(r + 1), indexing="ij")
    anchors = np.stack([ai, aj, ak], axis=-1).reshape(-1, 3)
    me = max(len(t) for t in einc)
    edge_face_idx = np.zeros((7 * n_anchor, me), np.int32)
    edge_face_mask = np.zeros((7 * n_anchor, me), np.float32)
    for ec, incs in enumerate(einc):
        sl = slice(ec * n_anchor, (ec + 1) * n_anchor)
        for j, (fc, d) in enumerate(incs):
            cell = anchors + np.asarray(d, np.int64)
            ok = ((cell >= 0) & (cell < r)).all(axis=1)
            lin = cell[:, 0] * r * r + cell[:, 1] * r + cell[:, 2]
            edge_face_idx[sl, j] = np.where(ok, fc * r3 + lin, 0).astype(
                np.int32)
            edge_face_mask[sl, j] = ok

    inv = {fc: [] for fc in range(12)}
    for ec, incs in enumerate(einc):
        for fc, d in incs:
            inv[fc].append((ec, d))
    ci, cj, ck = np.meshgrid(
        np.arange(r), np.arange(r), np.arange(r), indexing="ij")
    cells = np.stack([ci, cj, ck], axis=-1).reshape(-1, 3)
    face_edge_ids = np.empty((12 * r3, 3), np.int32)
    for fc in range(12):
        if len(inv[fc]) != 3:
            raise AssertionError(f"face class {fc} has edges {inv[fc]}")
        sl = slice(fc * r3, (fc + 1) * r3)
        for j, (ec, d) in enumerate(inv[fc]):
            m = cells - np.asarray(d, np.int64)  # anchor = cell - delta
            lin = m[:, 0] * (r + 1) * (r + 1) + m[:, 1] * (r + 1) + m[:, 2]
            face_edge_ids[sl, j] = (ec * n_anchor + lin).astype(np.int32)
    return edge_face_idx, edge_face_mask, face_edge_ids


@dataclasses.dataclass(frozen=True)
class FaceLattice:
    """Static lattice-class info (hashable nested tuples of ints)."""

    res: int
    classes: tuple
    edge_incidence: tuple


def lattice_offsets(grid) -> tuple | None:
    """The 14 neighbour offsets of the regular lattice (from a strictly
    interior vertex of a small grid of the same family), or None below
    res 2.  The grid's tets are not read: ``lattice_layout`` verifies
    them."""
    if grid.resolution < 2:
        return None
    probe = build_tet_grid(min(grid.resolution, 4))
    r = probe.resolution
    n = r + 1
    center = (r // 2) * n * n + (r // 2) * n + (r // 2)
    e = probe.tets[:, TET_EDGES].reshape(-1, 2)
    mask = (e[:, 0] == center) | (e[:, 1] == center)
    nbrs = np.unique(e[mask])
    nbrs = nbrs[nbrs != center]
    d = _vert_coords(nbrs.astype(np.int64), n) - _vert_coords(
        np.int64(center), n)
    offs = sorted(tuple(int(x) for x in row) for row in d)
    if not all(max(abs(x) for x in o) <= 1 for o in offs):
        raise AssertionError(f"lattice offsets outside {{-1,0,1}}^3: {offs}")
    return tuple(offs)


def lattice_tet_offsets(grid) -> tuple | None:
    """(6, 4, 3) nested tuple of {0, 1} offsets such that tet
    ``type * r^3 + cell`` has corner k at vertex ``cell + offset`` —
    verified against the tets array — or None for a non-lattice grid."""
    r = grid.resolution
    if r < 1:
        return None
    n = r + 1
    tets = np.asarray(grid.tets, np.int64)
    if tets.shape[0] != 6 * r**3:
        return None
    ii, jj, kk = np.meshgrid(
        np.arange(r), np.arange(r), np.arange(r), indexing="ij"
    )
    cell_base = (ii * n * n + jj * n + kk).reshape(-1)
    offs = []
    for ty in range(6):
        delta = tets[ty * r**3:(ty + 1) * r**3] - cell_base[:, None]
        corner = _vert_coords(delta[0], n)  # (4, 3)
        if (delta != delta[0]).any() or not np.isin(corner, (0, 1)).all():
            return None
        offs.append(tuple(map(tuple, corner.tolist())))
    return tuple(offs)


class LatticeLayout(NamedTuple):
    """The regular res-``res`` Kuhn lattice's layout: the stencil's 14
    neighbour ``offsets``, the (6, 4, 3) corner ``tet_offsets`` of the
    type-major tets and the class-major ``faces``."""

    res: int
    offsets: tuple
    tet_offsets: tuple
    faces: FaceLattice


def lattice_layout(grid) -> LatticeLayout | None:
    """The layout of a regular Kuhn grid of res >= 2 (its tets verified),
    else None as a whole: the one place that decides whether the stencil,
    the tet slices and the class-major faces apply."""
    if grid.resolution < 2:
        return None
    tet_offsets = lattice_tet_offsets(grid)
    if tet_offsets is None:
        return None
    r = int(grid.resolution)
    return LatticeLayout(
        res=r, offsets=lattice_offsets(grid), tet_offsets=tet_offsets,
        faces=FaceLattice(res=r, classes=face_class_table(),
                          edge_incidence=edge_class_table()))


def face_lattice_info(grid) -> FaceLattice | None:
    """FaceLattice for a regular Kuhn grid, else None."""
    layout = lattice_layout(grid)
    return None if layout is None else layout.faces


def build_lattice_topology(grid, face_arrays: bool = True):
    """The full ``Topology`` in the class-major padded face layout, or
    None for a non-lattice grid.  Face-derived arrays (edge incidence,
    edge pairs, vertex -> face incidence) come from the generic builders
    on the padded face list, the edge incidence and face -> edge ids from
    the class tables; with ``face_arrays=False`` those fields are None (the
    lattice step reads them only for the uncompacted normal term).  Hull-
    padded slots are left out of the tet neighbours.

    As in the JAX package, the vertex adjacency and the edge-face pairs
    come from the native builders wherever g++ is on the path (the pairs
    then listed edge by edge), else from numpy.  Where g++ is present but
    the library fails to build or load, this raises."""
    if lattice_layout(grid) is None:
        return None
    from ..native import build as native_build
    from ..native import topology as native

    use_native = native_build.native_available()
    r = grid.resolution
    n_point = grid.n_vertices
    tets = np.asarray(grid.tets, np.int32)
    face_v, face_tet, face_slot, valid, hull = build_lattice_faces(r)
    vai, vam, deg = (native.build_vertex_adjacency_native if use_native
                     else build_vertex_adjacency)(tets, n_point)
    nbr = build_tet_neighbors(face_tet[valid], face_slot[valid],
                              tets.shape[0])
    vti, vtm = build_vertex_tet_incidence(tets, n_point)
    face = dict.fromkeys(FACE_ARRAYS)
    if face_arrays:
        efi, efm, fei = build_lattice_edge_arrays(r)
        # flattening the incidence row-major is already edge-ascending
        flat_mask = efm.reshape(-1) > 0
        pa, pb = (native.build_edge_face_pairs_native if use_native
                  else build_edge_face_pairs)(face_v, n_point)
        vfi, vfm = build_vertex_face_incidence(face_v, n_point)
        face = dict(
            edge_face_idx=efi, edge_face_mask=efm, edge_pair_fa=pa,
            edge_pair_fb=pb, edge_entry_face=efi.reshape(-1)[flat_mask],
            edge_entry_edge=np.repeat(np.arange(efi.shape[0], dtype=np.int32),
                                      efi.shape[1])[flat_mask],
            face_edge_ids=fei, vert_face_inc_idx=vfi,
            vert_face_inc_mask=vfm)
    return Topology(
        n_vertices=int(n_point), n_tets=int(tets.shape[0]), tet_tx4=tets,
        face_fx3=face_v, face_tet_fx2=face_tet, face_slot_fx2=face_slot,
        hull_face_hx3=hull, vert_adj_idx=vai, vert_adj_mask=vam,
        vert_degree=deg, tet_neighbor_tx4=nbr, vert_tet_inc_idx=vti,
        vert_tet_inc_mask=vtm, **face)
