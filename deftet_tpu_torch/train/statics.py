"""Per-resolution static tensors of the train step (torch port of
deftet_tpu/train/statics.py, lattice topology only)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.geometry import tet_rest_inverse
from ..tetgrid import TetGrid, build_lattice_topology, build_tet_grid


class GridStatics(NamedTuple):
    init_pos_nx3: torch.Tensor        # (N, 3) float32 in [-0.5, 0.5]
    pos_mask_nx3: torch.Tensor        # (N, 3) float32 deformable mask
    tet_tx4: torch.Tensor             # (T, 4) int64
    face_fx3: torch.Tensor            # (12 r^3, 3) int64 class-major faces
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
                       device="cpu") -> GridStatics:
    """Build the Kuhn grid's lattice topology and lift it to ``device``."""
    if grid is None:
        grid = build_tet_grid(resolution)
    topo = build_lattice_topology(grid)
    if topo is None:
        raise NotImplementedError(
            "only the regular lattice grid (res >= 2) is ported")
    dev = torch.device(device)
    init_pos = torch.as_tensor(
        grid.centered_vertices().astype(np.float32), device=dev)
    tet_tx4 = torch.as_tensor(topo.tet_tx4.astype(np.int64), device=dev)
    return GridStatics(
        init_pos_nx3=init_pos,
        pos_mask_nx3=torch.as_tensor(grid.interior_mask, device=dev),
        tet_tx4=tet_tx4,
        face_fx3=torch.as_tensor(topo.face_fx3.astype(np.int64), device=dev),
        vert_degree=torch.as_tensor(topo.vert_degree, device=dev),
        rest_inverse_tx3x3=tet_rest_inverse(init_pos, tet_tx4),
    )
