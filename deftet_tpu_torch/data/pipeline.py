"""Occupancy texture of a watertight mesh (numpy, host-side; the
``occupancy_grid`` part of deftet_tpu/data/pipeline.py).

The train step labels deformed tet centers by one read of this offline
inside/outside grid over [-E, E]^3 (``ops.voxelize.
occupancy_from_grid_soa``).
"""

from __future__ import annotations

import numpy as np

OCC_GRID_EXTENT = 0.55  # grid spans [-E, E]^3 (1.1x the unit box)


def _ray_setup(verts, faces):
    """Shared +z-ray/triangle precomputation (float64)."""
    tri = verts[faces].astype(np.float64)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    denom = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    safe = np.abs(denom) > 1e-14
    denom = np.where(safe, denom, 1.0)
    return tri, v0, e1, e2, denom, safe


def _expand_ranges(lo, hi):
    """All (i, j) pairs for index ranges [lo0, hi0) x [lo1, hi1) per row;
    returns (row_id, i, j) flat arrays."""
    nx = hi[:, 0] - lo[:, 0]
    ny = hi[:, 1] - lo[:, 1]
    cnt = nx * ny
    tot = int(cnt.sum())
    if tot == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    row = np.repeat(np.arange(lo.shape[0], dtype=np.int64), cnt)
    local = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt
    )
    i = lo[row, 0] + local // ny[row]
    j = lo[row, 1] + local % ny[row]
    return row, i, j


def _parity_grid(verts, faces, xs, ys, zs, pair_budget: int = 4_000_000):
    """Inside/outside parity at the cell-center grid xs x ys x zs.

    Jittered +z ray parity; each triangle is tested only against the
    (x, y) columns its 2D bbox covers and its crossings are binned per
    column (suffix sum = crossings above each cell).  Returns float32
    (nx, ny, nz) in {0, 1}.
    """
    _, v0, e1, e2, denom, safe = _ray_setup(verts, faces)
    xsj = np.asarray(xs, np.float64) + 4.9e-7
    ysj = np.asarray(ys, np.float64) + 7.3e-7
    zsc = np.asarray(zs, np.float64)
    nx, ny, nz = len(xsj), len(ysj), len(zsc)

    tri = verts[faces].astype(np.float64)
    ix0 = np.searchsorted(xsj, tri[..., 0].min(1), "left")
    ix1 = np.searchsorted(xsj, tri[..., 0].max(1), "right")
    iy0 = np.searchsorted(ysj, tri[..., 1].min(1), "left")
    iy1 = np.searchsorted(ysj, tri[..., 1].max(1), "right")
    lo = np.stack([ix0, iy0], 1)
    hi = np.maximum(np.stack([ix1, iy1], 1), lo)
    hi[~safe] = lo[~safe]  # degenerate tris cover nothing

    bins = np.zeros(nx * ny * (nz + 1), np.int64)
    cnt = (hi - lo).prod(1)
    csum = np.cumsum(cnt)
    edges = [0]
    while edges[-1] < len(cnt):
        base = csum[edges[-1] - 1] if edges[-1] else 0
        nxt = int(np.searchsorted(csum, base + pair_budget))
        edges.append(max(nxt, edges[-1] + 1))
    for s, e in zip(edges[:-1], edges[1:]):
        t_id, ci, cj = _expand_ranges(lo[s:e], hi[s:e])
        if t_id.size == 0:
            continue
        t_id += s
        sx = xsj[ci] - v0[t_id, 0]
        sy = ysj[cj] - v0[t_id, 1]
        u = (sx * e2[t_id, 1] - sy * e2[t_id, 0]) / denom[t_id]
        v = (e1[t_id, 0] * sy - e1[t_id, 1] * sx) / denom[t_id]
        hit = (u >= 0) & (v >= 0) & (u + v <= 1)
        if not hit.any():
            continue
        z_hit = (v0[t_id, 2] + u * e1[t_id, 2] + v * e2[t_id, 2])[hit]
        col = ci[hit] * ny + cj[hit]
        b = np.searchsorted(zsc, z_hit, "left")
        bins += np.bincount(col * (nz + 1) + b, minlength=bins.shape[0])
    bins = bins.reshape(nx * ny, nz + 1)
    above = np.cumsum(bins[:, ::-1], axis=1)[:, ::-1][:, 1:]
    return (above % 2).astype(np.float32).reshape(nx, ny, nz)


def occupancy_grid(
    verts: np.ndarray, faces: np.ndarray, resolution: int
) -> np.ndarray:
    """Dense inside/outside grid over [-E, E]^3 sampled at cell centers."""
    g = resolution
    centers_1d = -OCC_GRID_EXTENT + (np.arange(g) + 0.5) / g * (
        2 * OCC_GRID_EXTENT
    )
    return _parity_grid(verts, faces, centers_1d, centers_1d, centers_1d)
