"""Watertight remeshing of arbitrary (possibly non-watertight) meshes (the
port's own numpy copy of deftet_tpu/data/watertight.py).

Normalize into a 0.9 box -> voxelize at ``res`` (the pipeline's
``_parity_grid``) -> extract the voxel boundary surface (axis-adjacent
occupancy transitions -> oriented quads) -> laplacian smooth ->
renormalize.  An offline host pass, run once per mesh.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .pipeline import _parity_grid


def normalize_mesh_to_box(
    verts: np.ndarray, box: float = 0.9
) -> np.ndarray:
    """Center + uniformly scale the mesh into box * [-0.5, 0.5]^3."""
    v = np.asarray(verts, dtype=np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2.0
    scale = (hi - lo).max()
    return (v - center) / max(scale, 1e-12) * box


def voxelize_occupancy(
    verts: np.ndarray, faces: np.ndarray, res: int
) -> np.ndarray:
    """(res, res, res) cell-center occupancy over [-0.5, 0.5]^3."""
    centers_1d = -0.5 + (np.arange(res) + 0.5) / res
    return _parity_grid(verts, faces, centers_1d, centers_1d, centers_1d)


def voxel_surface(occ: np.ndarray, res: int):
    """Triangles of the boundary between occupied and empty cells.

    Vertices lie on the voxel-corner lattice of [-0.5, 0.5]^3; each
    transition face contributes one outward-oriented quad (2 triangles).
    Returns (verts (V, 3) float64, faces (F, 3) int64), vertex-deduped.
    """
    n = res + 1  # corner lattice per axis
    quads = []

    # pad so hull cells emit faces against the outside
    occ_p = np.pad(occ, 1)

    # For axis a, faces between cell (i-1) and cell (i) along a.
    for axis in range(3):
        lo = np.moveaxis(occ_p, axis, 0)[:-1]
        hi = np.moveaxis(occ_p, axis, 0)[1:]
        diff = lo != hi
        sign = lo > hi  # True: occupied below -> outward normal +axis
        idx = np.argwhere(diff)  # (K, 3) in padded moveaxis coords
        if idx.size == 0:
            continue
        signs = sign[tuple(idx.T)]
        # face plane position along `axis` = idx[:,0] (padded) - 1 + 1
        plane = idx[:, 0] - 1 + 1  # corner index along axis in [0, res]
        u = idx[:, 1] - 1          # cell index along the remaining axes,
        v = idx[:, 2] - 1          # in ORIGINAL order (moveaxis keeps it)
        ax_u, ax_v = [a for a in range(3) if a != axis]
        # winding [c00,c10,c11,c01] has normal e_u x e_v: +axis for axes
        # 0 and 2, -axis for axis 1 (x^ x z^ = -y^) — flip there.
        if axis == 1:
            signs = ~signs
        # corners of the quad in (axis, ax_u, ax_v) coordinates
        for du, dv in ((0, 0),):
            c00 = np.zeros((idx.shape[0], 3), np.int64)
            c00[:, axis] = plane
            c00[:, ax_u] = u
            c00[:, ax_v] = v
            c10 = c00.copy()
            c10[:, ax_u] += 1
            c01 = c00.copy()
            c01[:, ax_v] += 1
            c11 = c10.copy()
            c11[:, ax_v] += 1
            # orientation: outward normal along +axis for sign=True
            q = np.where(
                signs[:, None, None],
                np.stack([c00, c10, c11, c01], axis=1),
                np.stack([c00, c01, c11, c10], axis=1),
            )
            quads.append(q)
    quad = np.concatenate(quads, axis=0)  # (Q, 4, 3) corner lattice coords
    corner_idx = (
        quad[..., 0] * n * n + quad[..., 1] * n + quad[..., 2]
    )  # (Q, 4)
    tris = np.concatenate(
        [corner_idx[:, [0, 1, 2]], corner_idx[:, [0, 2, 3]]], axis=0
    )
    used, inverse = np.unique(tris.reshape(-1), return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int64)
    gi = used // (n * n)
    gj = (used // n) % n
    gk = used % n
    verts = np.stack([gi, gj, gk], axis=1).astype(np.float64) / res - 0.5
    return verts, faces


def laplacian_smooth(
    verts: np.ndarray, faces: np.ndarray, iterations: int = 3,
    alpha: float = 1.0,
) -> np.ndarray:
    """Uniform laplacian smoothing (the 3x smooth of dataloader.py:55-58)."""
    v = np.asarray(verts, dtype=np.float64).copy()
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    key = e[:, 0] * v.shape[0] + e[:, 1]
    uniq = np.unique(key)
    src = uniq // v.shape[0]
    dst = uniq % v.shape[0]
    deg = np.bincount(src, minlength=v.shape[0]).astype(np.float64)
    deg = np.maximum(deg, 1.0)
    for _ in range(iterations):
        nbr_sum = np.zeros_like(v)
        np.add.at(nbr_sum, src, v[dst])
        v = (1 - alpha) * v + alpha * nbr_sum / deg[:, None]
    return v


def watertight_from_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    res: int = 100,
    smooth_iterations: int = 3,
    box: float = 0.9,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full watertighting pass (MakeSurfaceMesh, dataloader.py:24-61)."""
    v = normalize_mesh_to_box(verts, box)
    occ = voxelize_occupancy(v, faces, res)
    sv, sf = voxel_surface(occ, res)
    sv = laplacian_smooth(sv, sf, smooth_iterations)
    sv = normalize_mesh_to_box(sv, box)
    return sv.astype(np.float32), sf.astype(np.int32)
