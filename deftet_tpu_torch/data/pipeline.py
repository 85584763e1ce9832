"""Host-side data pipeline (numpy and scipy): the port's own copy of
deftet_tpu/data/pipeline.py.

Record schema per shape, padded so that batches have static shapes:

  surface_points (S, 3)     area-weighted samples on the mesh
  sdf_points     (P, 3)     uniform in 1.05 * [-0.5, 0.5]^3
  sdf            (P,)       signed distance, positive inside
  occ_grid       (G, G, G)  inside/outside texture over [-E, E]^3
  verts (Vmax, 3), faces (Fmax, 3), n_verts, n_faces — the padded GT mesh;
  imgs (H, W, 3), cam_matrix (4, 4) — with images, for the DISN branch.

Shards come from the procedural shape family (``build_dataset``) or from a
directory tree of OBJ meshes, watertighted first (``build_dataset_from_
meshes``).

The train step labels deformed tet centers by one read of the occupancy
texture (``ops.voxelize.occupancy_from_grid_soa``).
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Iterator, List, Sequence

import numpy as np

from .shapes import random_shape, shape_family

OCC_GRID_EXTENT = 0.55  # grid spans [-E, E]^3 (1.1x the unit box)
IMG_SIZE = 64  # the DISN images' height and width


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


def _point_triangle_sq_np(p, a, b, c):
    """Numpy twin of ops.tri_distance.point_triangle_squared_distance."""
    ab, ac, ap = b - a, c - a, p - a
    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    eps = 1e-20

    def safe_div(x, y):
        return x / np.where(np.abs(y) < eps, 1.0, y)

    v_ab = safe_div(d1, d1 - d3)
    w_ac = safe_div(d2, d2 - d6)
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = va + vb + vc
    v_in = safe_div(vb, denom)
    w_in = safe_div(vc, denom)
    closest = a + v_in[..., None] * ab + w_in[..., None] * ac
    closest = np.where(
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
        b + w_bc[..., None] * (c - b), closest)
    closest = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                       a + w_ac[..., None] * ac, closest)
    closest = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                       a + v_ab[..., None] * ab, closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, closest)
    closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, closest)
    return np.sum((p - closest) ** 2, -1)


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


def _min_sq_distance(points, verts, faces, k: int = 32,
                     dist_chunk: int = 512):
    """Exact min squared point-to-mesh distance, KD-tree pruned.

    Nearest-centroid candidates give an upper bound; any triangle whose
    centroid lies within bound + max_triangle_radius is then checked
    exactly, so the result equals the brute-force loop.
    """
    tri = verts[faces].astype(np.float64)
    p = points.astype(np.float64)
    if faces.shape[0] <= 2048:
        d2 = np.full(p.shape[0], np.inf)
        for s in range(0, tri.shape[0], dist_chunk):
            t = tri[s:s + dist_chunk]
            d = _point_triangle_sq_np(
                p[:, None], t[None, :, 0], t[None, :, 1], t[None, :, 2]
            )
            d2 = np.minimum(d2, d.min(axis=1))
        return d2
    from scipy.spatial import cKDTree

    cent = tri.mean(1)
    rad = np.sqrt(((tri - cent[:, None]) ** 2).sum(-1).max(1))
    rad_max = float(rad.max())
    tree = cKDTree(cent)
    k = min(k, faces.shape[0])
    dc, ci = tree.query(p, k=k, workers=-1)
    cand = tri[ci]  # (N, k, 3, 3)
    d2 = _point_triangle_sq_np(
        p[:, None], cand[:, :, 0], cand[:, :, 1], cand[:, :, 2]
    ).min(1)
    d_up = np.sqrt(d2)
    # a triangle outside the k candidates can only be closer if its
    # centroid is nearer than d_up + rad_max, i.e. inside the unexplored
    # shell beyond the k-th centroid
    need = np.nonzero(dc[:, -1] < d_up + rad_max)[0]
    if need.size:
        balls = tree.query_ball_point(p[need], d_up[need] + rad_max)
        for i, idx in zip(need, balls):
            if not idx:
                continue
            t = tri[np.asarray(idx)]
            d = _point_triangle_sq_np(p[i], t[:, 0], t[:, 1], t[:, 2])
            d2[i] = min(d2[i], float(d.min()))
    return d2


def mesh_sdf_points(
    verts: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
    dist_chunk: int = 512,
):
    """Uniform box samples + signed distance (dataloader.py:91-115):
    sdf = sign * distance, sign = +1 inside / -1 outside."""
    points = 1.05 * (rng.uniform(size=(num_points, 3)) - 0.5)
    sign = _check_sign_rast(verts, faces, points) * 2.0 - 1.0
    d2 = _min_sq_distance(points, verts, faces, dist_chunk=dist_chunk)
    return points.astype(np.float32), (sign * np.sqrt(d2)).astype(np.float32)


def occupancy_grid(
    verts: np.ndarray, faces: np.ndarray, resolution: int
) -> np.ndarray:
    """Dense inside/outside grid over [-E, E]^3 sampled at cell centers."""
    g = resolution
    centers_1d = -OCC_GRID_EXTENT + (np.arange(g) + 0.5) / g * (
        2 * OCC_GRID_EXTENT
    )
    return _parity_grid(verts, faces, centers_1d, centers_1d, centers_1d)


def make_example(
    verts: np.ndarray,
    faces: np.ndarray,
    n_surface: int,
    n_sdf: int,
    rng: np.random.Generator,
    occ_grid_res: int = 64,
    with_image: bool = False,
) -> Dict[str, np.ndarray]:
    surface = sample_surface(verts, faces, n_surface, rng)
    sdf_pts, sdf = mesh_sdf_points(verts, faces, n_sdf, rng)
    out = {
        "surface_points": surface.astype(np.float32),
        "sdf_points": sdf_pts,
        "sdf": sdf,
        "occ_grid": occupancy_grid(verts, faces, occ_grid_res),
        "verts": verts.astype(np.float32),
        "faces": faces.astype(np.int32),
    }
    if with_image:
        # an image and its row-vector camera matrix for the DISN branch;
        # the camera is drawn after the surface and SDF draws
        from .image_render import random_camera, render_mesh_image

        cam = random_camera(rng)
        out["imgs"] = render_mesh_image(verts.astype(np.float32), faces, cam,
                                        IMG_SIZE, IMG_SIZE)
        out["cam_matrix"] = cam
    return out


def _shard_name(
    seed: int, i: int, occ_grid_res: int, with_image: bool = False
) -> str:
    # non-default options get their own cache key (the default keeps
    # round-1 cache names valid)
    suffix = "" if occ_grid_res == 64 else f"_g{occ_grid_res}"
    if with_image:
        suffix += "_img"
    return f"shape_{seed}_{i:05d}{suffix}.npz"


def _build_one_shard(args) -> str:
    root, seed, i, n_surface, n_sdf, level, occ_grid_res, with_image = args
    path = os.path.join(
        root, _shard_name(seed, i, occ_grid_res, with_image)
    )
    if os.path.exists(path):
        return path
    shape_seed = seed * 10007 + i
    verts, faces = random_shape(shape_seed, level=level)
    rng = np.random.default_rng(seed * 65537 + i)
    ex = make_example(
        verts, faces, n_surface, n_sdf, rng, occ_grid_res=occ_grid_res,
        with_image=with_image,
    )
    ex["category"] = np.str_(shape_family(shape_seed))
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **ex)
    os.replace(tmp, path)
    return path


def build_dataset(
    root: str,
    n_shapes: int,
    n_surface: int = 20000,
    n_sdf: int = 20000,
    seed: int = 0,
    level: int = 3,
    num_workers: int = 8,
    occ_grid_res: int = 64,
    with_images: bool = False,
) -> List[str]:
    """Generate + cache npz shards; returns the shard paths.

    Preprocessing fans out over `num_workers` processes — the role of the
    reference's 8 DataLoader workers (dataloader.py:199-207), but offline
    and cached instead of per-epoch.
    """
    os.makedirs(root, exist_ok=True)
    jobs = [
        (root, seed, i, n_surface, n_sdf, level, occ_grid_res, with_images)
        for i in range(n_shapes)
    ]
    pending = [j for j in jobs if not os.path.exists(
        os.path.join(root, _shard_name(seed, j[2], occ_grid_res, with_images))
    )]
    if pending and num_workers > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(min(num_workers, len(pending))) as pool:
            pool.map(_build_one_shard, pending)
    else:
        for j in pending:
            _build_one_shard(j)
    return [
        os.path.join(root, _shard_name(seed, i, occ_grid_res, with_images))
        for i in range(n_shapes)
    ]


def _mesh_shard_path(root: str, mesh_path: str) -> str:
    stem = os.path.splitext(os.path.basename(mesh_path))[0]
    return os.path.join(root, f"mesh_{stem}.npz")


def _build_mesh_shard(args) -> str:
    (root, mesh_path, n_surface, n_sdf, seed, watertight_res,
     occ_grid_res, with_image) = args
    path = _mesh_shard_path(root, mesh_path)
    if os.path.exists(path):
        return path
    from ..utils.objio import load_obj
    from .watertight import watertight_from_mesh

    raw_v, raw_f = load_obj(mesh_path)
    verts, faces = watertight_from_mesh(raw_v, raw_f, res=watertight_res)
    stem = os.path.splitext(os.path.basename(mesh_path))[0]
    # crc32, not hash(): str hash is salted per process, which would make
    # shard contents depend on which worker generated them
    rng = np.random.default_rng(
        seed ^ (zlib.crc32(stem.encode()) & 0x7FFFFFFF))
    ex = make_example(verts, faces, n_surface, n_sdf, rng,
                      occ_grid_res=occ_grid_res, with_image=with_image)
    cat = os.path.basename(os.path.dirname(os.path.abspath(mesh_path)))
    ex["category"] = np.str_(cat or "mesh")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **ex)
    os.replace(tmp, path)
    return path


def build_dataset_from_meshes(
    root: str,
    mesh_dir: str,
    n_surface: int = 20000,
    n_sdf: int = 20000,
    seed: int = 0,
    watertight_res: int = 100,
    num_workers: int = 8,
    occ_grid_res: int = 64,
    with_images: bool = False,
) -> List[str]:
    """Ingest a directory tree of OBJ meshes into cached npz shards; returns
    the shard paths.

    Each mesh is watertighted (voxelize at ``watertight_res`` -> boundary
    surface -> laplacian smooth), then sampled as ``make_example`` samples
    a procedural shape, from a generator seeded with ``seed`` xor the
    crc32 of the file's stem.  Shards are cached per mesh file; the
    category is the parent directory's name.
    """
    meshes = []
    for dirpath, _, files in sorted(os.walk(mesh_dir)):
        for f in sorted(files):
            if f.lower().endswith(".obj"):
                meshes.append(os.path.join(dirpath, f))
    if not meshes:
        raise FileNotFoundError(f"no .obj meshes under {mesh_dir}")
    os.makedirs(root, exist_ok=True)
    jobs = [(root, m, n_surface, n_sdf, seed, watertight_res, occ_grid_res,
             with_images) for m in meshes]
    pending = [j for j in jobs
               if not os.path.exists(_mesh_shard_path(root, j[1]))]
    if pending and num_workers > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(min(num_workers, len(pending))) as pool:
            pool.map(_build_mesh_shard, pending)
    else:
        for j in pending:
            _build_mesh_shard(j)
    return [_mesh_shard_path(root, m) for m in meshes]


class ShapeDataset:
    """npz-backed dataset with static padding across the whole set."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        sizes = [self._load(i) for i in range(len(self.paths))]
        self.max_verts = max(s["verts"].shape[0] for s in sizes)
        self.max_faces = max(s["faces"].shape[0] for s in sizes)

    def _load(self, i: int) -> Dict[str, np.ndarray]:
        if i not in self._cache:
            with np.load(self.paths[i]) as d:
                self._cache[i] = {k: d[k] for k in d.files}
        return self._cache[i]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        ex = self._load(i)
        v, f = ex["verts"], ex["faces"]
        verts = np.zeros((self.max_verts, 3), np.float32)
        verts[: v.shape[0]] = v
        faces = np.zeros((self.max_faces, 3), np.int32)
        faces[: f.shape[0]] = f
        out = {
            "surface_points": ex["surface_points"],
            "sdf_points": ex["sdf_points"],
            "sdf": ex["sdf"],
            "verts": verts,
            "faces": faces,
            "n_verts": np.int32(v.shape[0]),
            "n_faces": np.int32(f.shape[0]),
        }
        if "occ_grid" in ex:  # older caches may predate the grid oracle
            out["occ_grid"] = ex["occ_grid"]
        if "imgs" in ex:  # the DISN image branch
            out["imgs"] = ex["imgs"]
            out["cam_matrix"] = ex["cam_matrix"]
        if "category" in ex:
            out["category"] = str(ex["category"])
        return out


def batch_iterator(
    dataset: ShapeDataset,
    batch_size: int,
    rng: np.random.Generator | None = None,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked numpy batches; shuffles when rng is given
    (DataLoader semantics of dataloader.py:199-207)."""
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s : s + batch_size]
        if drop_last and idx.shape[0] < batch_size:
            return
        items = [dataset[int(i)] for i in idx]
        out = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], str):
                out[k] = vals  # non-numeric metadata rides as a list
            else:
                out[k] = np.stack(vals, axis=0)
        yield out
