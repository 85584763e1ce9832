"""Per-grid static tensors of the train step (torch port of
deftet_tpu/train/statics.py): the regular lattice's class-major topology,
or any tet grid's through the generic builders, native (g++) where a
compiler is on the path and numpy otherwise, as in the JAX package."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.geometry import tet_rest_inverse
from ..tetgrid import (
    TetGrid,
    Topology,
    build_lattice_topology,
    build_tet_grid,
    build_topology,
)


class GridStatics(NamedTuple):
    """Index tensors are int64.  The face-derived gather tables
    (``edge_face_*``, ``face_edge_ids``, ``vert_face_inc_*``) are None
    where they were not built (the lattice at a compaction budget)."""

    init_pos_nx3: torch.Tensor        # (N, 3) float32 in [-0.5, 0.5]
    pos_mask_nx3: torch.Tensor        # (N, 3) float32 deformable mask
    tet_tx4: torch.Tensor             # (T, 4)
    face_fx3: torch.Tensor            # (F, 3) interior faces
    face_tet_fx2: torch.Tensor        # (F, 2) owning tets
    edge_face_idx: torch.Tensor       # (E, M) faces incident per edge
    edge_face_mask: torch.Tensor      # (E, M) float32
    face_edge_ids: torch.Tensor       # (F, 3)
    vert_face_inc_idx: torch.Tensor   # (N, M) face-corner slots
    vert_face_inc_mask: torch.Tensor  # (N, M) float32
    vert_tet_inc_idx: torch.Tensor    # (N, Mt) tet-corner slots
    vert_tet_inc_mask: torch.Tensor   # (N, Mt) float32
    vert_adj_idx: torch.Tensor        # (N, Ma) neighbour vertices
    vert_adj_mask: torch.Tensor       # (N, Ma) float32
    vert_degree: torch.Tensor         # (N,) int32
    rest_inverse_tx3x3: torch.Tensor  # (T, 3, 3) float32

    @property
    def n_vertices(self) -> int:
        return self.init_pos_nx3.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tet_tx4.shape[0]


def lattice_offsets(grid: TetGrid) -> tuple | None:
    """The 14 neighbour offsets of the regular lattice (from a strictly
    interior vertex of a small grid of the same family), or None."""
    if grid.resolution < 2:
        return None
    from ..tetgrid.topology import TET_EDGES

    probe = build_tet_grid(min(grid.resolution, 4))
    r = probe.resolution
    n = r + 1
    center = (r // 2) * n * n + (r // 2) * n + (r // 2)
    e = probe.tets[:, TET_EDGES].reshape(-1, 2)
    mask = (e[:, 0] == center) | (e[:, 1] == center)
    nbrs = np.unique(e[mask])
    nbrs = nbrs[nbrs != center]

    def coords(i):
        return (i // (n * n), (i // n) % n, i % n)

    c0 = np.array(coords(center))
    offs = sorted(
        tuple(int(x) for x in (np.array(coords(int(i))) - c0)) for i in nbrs
    )
    if not all(max(abs(x) for x in o) <= 1 for o in offs):
        raise AssertionError(f"lattice offsets outside {{-1,0,1}}^3: {offs}")
    return tuple(offs)


def lattice_tet_offsets(grid: TetGrid) -> tuple | None:
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
        if (delta != delta[0]).any():
            return None
        enc = delta[0]
        di, dj, dk = enc // (n * n), (enc // n) % n, enc % n
        if not all(((d == 0) | (d == 1)).all() for d in (di, dj, dk)):
            return None
        offs.append(tuple((int(di[k]), int(dj[k]), int(dk[k]))
                          for k in range(4)))
    return tuple(offs)


def build_grid_statics(resolution: int, grid: TetGrid | None = None,
                       topology: Topology | None = None, device="cpu",
                       face_arrays: bool = True) -> GridStatics:
    """Build (or adopt) a grid and its topology and lift them to
    ``device``: the class-major lattice topology for the regular Kuhn
    grid, else ``build_topology``, as in the JAX package through the
    native builders wherever g++ is on the path (``build_topology_native``;
    its edge-face pairs listed edge by edge) and raising where g++ is
    present but the library fails to build or load.  ``face_arrays=False``
    skips the lattice's face-derived gather tables (read only by the
    uncompacted normal term)."""
    if grid is None:
        grid = build_tet_grid(resolution)
    if topology is None:
        topology = build_lattice_topology(grid, face_arrays=face_arrays)
    if topology is None:
        topology = build_topology(grid.tets, grid.n_vertices)
    dev = torch.device(device)

    def lift(name, dtype=None):
        a = getattr(topology, name)
        if a is None:
            return None
        t = torch.as_tensor(a)
        return t.to(device=dev, dtype=torch.int64 if dtype is None and
                    not t.is_floating_point() else dtype)

    init_pos = torch.as_tensor(
        grid.centered_vertices().astype(np.float32), device=dev)
    tet_tx4 = lift("tet_tx4")
    return GridStatics(
        init_pos_nx3=init_pos,
        pos_mask_nx3=torch.as_tensor(
            grid.interior_mask.astype(np.float32), device=dev),
        tet_tx4=tet_tx4,
        face_fx3=lift("face_fx3"),
        face_tet_fx2=lift("face_tet_fx2"),
        edge_face_idx=lift("edge_face_idx"),
        edge_face_mask=lift("edge_face_mask"),
        face_edge_ids=lift("face_edge_ids"),
        vert_face_inc_idx=lift("vert_face_inc_idx"),
        vert_face_inc_mask=lift("vert_face_inc_mask"),
        vert_tet_inc_idx=lift("vert_tet_inc_idx"),
        vert_tet_inc_mask=lift("vert_tet_inc_mask"),
        vert_adj_idx=lift("vert_adj_idx"),
        vert_adj_mask=lift("vert_adj_mask"),
        vert_degree=lift("vert_degree", torch.int32),
        rest_inverse_tx3x3=tet_rest_inverse(init_pos, tet_tx4),
    )


def statics_to(statics: GridStatics, device) -> GridStatics:
    """``statics`` with every tensor on ``device``."""
    return GridStatics(*(None if t is None else t.to(device)
                         for t in statics))
