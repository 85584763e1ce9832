"""The benchmark's traffic generator: one function for every cell, which
reads a cell's parameters (its workload file's ``params``) and the run's
seed and returns the host numpy records that the cell feeds the program.

The shape family (``shapes.py``), the surface sampling, the +z ray
parity and the occupancy texture are frozen copies of the port's data
pipeline, so a change to the program cannot change its inputs.

Training records carry ``surface_points`` and ``occ_grid``, what the
train step reads.  Evaluation records add ``sdf_points`` (uniform in
1.05 x the unit box) with their inside labels ``sdf`` (+1 inside, -1
outside: the inference step reads only the sign, so the distances are
not computed) and the padded GT mesh (``verts``, ``faces``,
``n_verts``, ``n_faces``).
"""

from __future__ import annotations

import numpy as np

from .shapes import random_shape

OCC_GRID_EXTENT = 0.55  # the texture spans [-E, E]^3 (1.1x the unit box)


def sample_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Area-weighted uniform surface sampling (mesh_utils.py:56-92)."""
    tri = verts[faces]  # (F, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(n, axis=1)
    probs = areas / areas.sum()
    choice = rng.choice(faces.shape[0], size=num_points, p=probs)
    t = tri[choice]
    u = np.sqrt(rng.uniform(size=(num_points, 1)))
    v = rng.uniform(size=(num_points, 1))
    return (1 - u) * t[:, 0] + (u * (1 - v)) * t[:, 1] + u * v * t[:, 2]


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


def _check_sign_rast(verts, faces, points, pair_budget: int = 4_000_000):
    """+z ray parity (the jitter of ops.check_sign, in float64) for
    scattered points.

    Points are binned into a 2D (x, y) grid of ray columns; each
    triangle is tested only against the points in the columns its bbox
    covers.  Bit-identical parity math (same jitter, same float64
    Möller–Trumbore projection), ~res× less work.
    """
    n_pts = points.shape[0]
    if n_pts == 0:
        return np.zeros(0, np.float32)
    _, v0, e1, e2, denom, safe = _ray_setup(verts, faces)
    q = points.astype(np.float64) + np.array([4.9e-7, 7.3e-7, 0.0])
    res = int(np.clip(np.sqrt(n_pts), 8, 256))
    lo2 = q[:, :2].min(0)
    hi2 = q[:, :2].max(0)
    w = np.maximum(hi2 - lo2, 1e-12)
    cell = np.clip(((q[:, :2] - lo2) / w * res).astype(np.int64), 0, res - 1)
    col = cell[:, 0] * res + cell[:, 1]
    order = np.argsort(col, kind="stable")
    bounds = np.searchsorted(col[order], np.arange(res * res + 1))

    tri = verts[faces].astype(np.float64)
    tmin = tri[..., :2].min(1)
    tmax = tri[..., :2].max(1)
    clo = np.clip(((tmin - lo2) / w * res).astype(np.int64), 0, res - 1)
    chi = np.clip(((tmax - lo2) / w * res).astype(np.int64), 0, res - 1) + 1
    # triangles fully outside the point extent cover nothing
    out = (tmax[:, 0] < lo2[0]) | (tmin[:, 0] > hi2[0]) | \
          (tmax[:, 1] < lo2[1]) | (tmin[:, 1] > hi2[1]) | ~safe
    chi[out] = clo[out]

    count = np.zeros(n_pts, np.int64)
    pts_per_col = bounds[1:] - bounds[:-1]
    t_all, ci_all, cj_all = _expand_ranges(clo, chi)
    col_all = ci_all * res + cj_all
    npts_pair = pts_per_col[col_all]
    keep = npts_pair > 0
    t_all, col_all, npts_pair = t_all[keep], col_all[keep], npts_pair[keep]
    csum = np.cumsum(npts_pair)
    edges = [0]
    while edges[-1] < len(npts_pair):
        base = csum[edges[-1] - 1] if edges[-1] else 0
        nxt = int(np.searchsorted(csum, base + pair_budget))
        edges.append(max(nxt, edges[-1] + 1))
    for s, e in zip(edges[:-1], edges[1:]):
        np_pair = npts_pair[s:e]
        tot = int(np_pair.sum())
        if tot == 0:
            continue
        pair = np.repeat(np.arange(e - s, dtype=np.int64), np_pair)
        local = np.arange(tot, dtype=np.int64) - np.repeat(
            np.cumsum(np_pair) - np_pair, np_pair
        )
        p_id = order[bounds[col_all[s:e][pair]] + local]
        t_id = t_all[s:e][pair]
        sx = q[p_id, 0] - v0[t_id, 0]
        sy = q[p_id, 1] - v0[t_id, 1]
        u = (sx * e2[t_id, 1] - sy * e2[t_id, 0]) / denom[t_id]
        v = (e1[t_id, 0] * sy - e1[t_id, 1] * sx) / denom[t_id]
        hit = (u >= 0) & (v >= 0) & (u + v <= 1)
        z_hit = v0[t_id, 2] + u * e1[t_id, 2] + v * e2[t_id, 2]
        hit &= z_hit > q[p_id, 2]
        count += np.bincount(p_id[hit], minlength=n_pts)
    return (count % 2).astype(np.float32)


def occupancy_grid(
    verts: np.ndarray, faces: np.ndarray, resolution: int
) -> np.ndarray:
    """Dense inside/outside grid over [-E, E]^3 sampled at cell centers."""
    g = resolution
    centers_1d = -OCC_GRID_EXTENT + (np.arange(g) + 0.5) / g * (
        2 * OCC_GRID_EXTENT
    )
    return _parity_grid(verts, faces, centers_1d, centers_1d, centers_1d)


def shape_ids(params: dict, seed: int) -> list:
    """The cell's shape ids: ``seed * 10007 + i`` (the names the port's
    ``build_dataset`` gives a dataset's shapes) or, with ``held_out``,
    ids drawn from the seed."""
    n = int(params["n_shapes"])
    if params.get("held_out"):
        rng = np.random.default_rng([seed, 7919])
        return [int(x) for x in rng.integers(0, 2**31 - 1, size=n)]
    return [seed * 10007 + i for i in range(n)]


def make_records(params: dict, seed: int) -> list:
    """One record a shape, each from its own generator, so a record does
    not depend on the others."""
    records = []
    for i, sid in enumerate(shape_ids(params, seed)):
        verts, faces = random_shape(sid, level=int(params["level"]))
        rng = np.random.default_rng([seed, i])
        rec = {"surface_points": sample_surface(
                   verts, faces, int(params["n_surface"]),
                   rng).astype(np.float32),
               "occ_grid": occupancy_grid(verts, faces,
                                          int(params["occ_res"]))}
        n_sdf = int(params.get("n_sdf", 0))
        if n_sdf:
            pts = 1.05 * (rng.uniform(size=(n_sdf, 3)) - 0.5)
            rec["sdf_points"] = pts.astype(np.float32)
            rec["sdf"] = (_check_sign_rast(verts, faces, pts) * 2.0
                          - 1.0).astype(np.float32)
            rec["verts"] = verts.astype(np.float32)
            rec["faces"] = faces.astype(np.int32)
        records.append(rec)
    return records


def stack(records: list) -> dict:
    """A batch of records, the GT meshes zero-padded to the batch's
    largest as the port's ``ShapeDataset`` pads them."""
    out = {k: np.stack([r[k] for r in records])
           for k in records[0] if k not in ("verts", "faces")}
    if "verts" in records[0]:
        b = len(records)
        nv = max(r["verts"].shape[0] for r in records)
        nf = max(r["faces"].shape[0] for r in records)
        out["verts"] = np.zeros((b, nv, 3), np.float32)
        out["faces"] = np.zeros((b, nf, 3), np.int32)
        for i, r in enumerate(records):
            out["verts"][i, :r["verts"].shape[0]] = r["verts"]
            out["faces"][i, :r["faces"].shape[0]] = r["faces"]
        out["n_verts"] = np.array([r["verts"].shape[0] for r in records],
                                  np.int32)
        out["n_faces"] = np.array([r["faces"].shape[0] for r in records],
                                  np.int32)
    return out


def batch_order(n_records: int, batch: int, seed: int, passes: int):
    """``passes`` lists of batches (index arrays), each pass a fresh
    shuffle of the records drawn from the seed; a pass drops its last
    partial batch, as the port's ``batch_iterator`` does."""
    rng = np.random.default_rng([seed, 104729])
    out = []
    for _ in range(passes):
        order = rng.permutation(n_records)
        out.append([order[s:s + batch]
                    for s in range(0, n_records - batch + 1, batch)])
    return out
