"""Kuhn tetrahedral grid over [0, 1]^3 and quartet ``.tet`` file IO
(numpy; copy of deftet_tpu/tetgrid/grid.py).

Each lattice cube splits into 6 tetrahedra around its main diagonal;
tets are type-major (``tet = type * r^3 + cell``) and oriented so the
loss stack's volume convention V = -det([A-D, B-D, C-D]) / 6 > 0 holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# The 6 tetrahedra of the Kuhn subdivision of the unit cube, as corner
# indices in the (dx, dy, dz) binary corner ordering c = dx*4 + dy*2 + dz.
_CUBE_TETS = np.array(
    [
        [0b000, 0b100, 0b110, 0b111],
        [0b000, 0b110, 0b010, 0b111],
        [0b000, 0b010, 0b011, 0b111],
        [0b000, 0b011, 0b001, 0b111],
        [0b000, 0b001, 0b101, 0b111],
        [0b000, 0b101, 0b100, 0b111],
    ],
    dtype=np.int64,
)


@dataclasses.dataclass
class TetGrid:
    """vertices (N, 3) float64 in [0, 1]^3; tets (T, 4) int32;
    interior_mask (N, 3) float32, 1 where a coordinate may deform."""

    vertices: np.ndarray
    tets: np.ndarray
    interior_mask: np.ndarray
    resolution: int = 0

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_tets(self) -> int:
        return int(self.tets.shape[0])

    def centered_vertices(self) -> np.ndarray:
        """Vertices shifted to [-0.5, 0.5]^3."""
        return self.vertices - 0.5


def _signed_volume(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    p = verts[tets]
    a = p[:, 0] - p[:, 3]
    b = p[:, 1] - p[:, 3]
    c = p[:, 2] - p[:, 3]
    det = np.einsum("ti,ti->t", a, np.cross(b, c))
    return -det / 6.0


def orient_tets(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Swap two vertices of any tet with negative convention-volume."""
    tets = np.asarray(tets, dtype=np.int64).copy()
    flip = _signed_volume(verts, tets) < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1].copy(), tets[flip, 0].copy()
    return tets


def boundary_vertex_mask(vertices: np.ndarray, spacing: float) -> np.ndarray:
    """Snap near-boundary coords onto the box walls in place; return the
    interior (deformable) mask."""
    vertices[vertices <= (0 + spacing / 4.0)] = 0.0
    vertices[vertices >= (1 - spacing / 4.0)] = 1.0
    mask = np.logical_and(vertices < 1, vertices > 0)
    return mask.astype(np.float32)


def build_tet_grid(resolution: int) -> TetGrid:
    """Conforming 6-tets-per-cube grid with ``resolution`` cells per axis."""
    r = int(resolution)
    if r < 1:
        raise ValueError(f"resolution must be >= 1, got {r}")
    n = r + 1
    grid = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    vertices = grid.astype(np.float64) / r

    ii, jj, kk = np.meshgrid(
        np.arange(r), np.arange(r), np.arange(r), indexing="ij"
    )
    origins = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    corner_off = np.array(
        [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=np.int64
    )
    corner_idx = (
        (origins[:, None, 0] + corner_off[None, :, 0]) * n * n
        + (origins[:, None, 1] + corner_off[None, :, 1]) * n
        + (origins[:, None, 2] + corner_off[None, :, 2])
    )
    tets = corner_idx[:, _CUBE_TETS].transpose(1, 0, 2).reshape(-1, 4)
    tets = orient_tets(vertices, tets)
    mask = boundary_vertex_mask(vertices, 1.0 / r)
    return TetGrid(
        vertices=vertices,
        tets=tets.astype(np.int32),
        interior_mask=mask,
        resolution=r,
    )
