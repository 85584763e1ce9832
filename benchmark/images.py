"""The DISN cell's input images: normal-shaded z-buffer renders of the
cell's shapes from random viewpoints, with the 4x4 row-vector camera of
each (a frozen copy of the port's ``data/image_render.py``, so a change
to the program cannot change its inputs; ``views`` is the benchmark's).

ShapeNet's renderings (the 3D-R2N2 / DISN sets: 137 x 137, 24 views a
shape) are not redistributable, so each shape is rendered itself:
``homo_row @ M -> (x', y', z)``, screen xy = (x'/z, y'/z) in [-1, 1].
"""

from __future__ import annotations

import numpy as np

from .shapes import random_shape
from .traffic import shape_ids


def random_camera(
    rng: np.random.Generator,
    dist: float = 1.8,
    fov_deg: float = 40.0,
) -> np.ndarray:
    """Random look-at-origin camera as a (4, 4) row-vector matrix.

    Eye on a radius-`dist` sphere (elevation limited to +-37deg like
    typical ShapeNet turntable renders); projection divides by the
    camera-frame depth, so `homo @ M` followed by xy/z gives [-1, 1]
    screen coordinates with the whole unit box in frame.
    """
    theta = rng.uniform(0.0, 2.0 * np.pi)
    cos_el = rng.uniform(-0.6, 0.6)
    el = np.arcsin(cos_el)
    eye = dist * np.array(
        [np.cos(el) * np.cos(theta), np.sin(el), np.cos(el) * np.sin(theta)]
    )
    fwd = -eye / np.linalg.norm(eye)
    world_up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(fwd, world_up)) > 0.98:
        world_up = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)

    f = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[:3, 0] = f * right
    m[:3, 1] = f * up
    m[:3, 2] = fwd
    m[3, 0] = -f * np.dot(eye, right)
    m[3, 1] = -f * np.dot(eye, up)
    m[3, 2] = -np.dot(eye, fwd)
    m[3, 3] = 1.0
    return m.astype(np.float32)


def render_mesh_image(
    verts: np.ndarray,
    faces: np.ndarray,
    cam_4x4: np.ndarray,
    height: int = 64,
    width: int = 64,
) -> np.ndarray:
    """Normal-shaded z-buffer rasterization, (H, W, 3) float32 in [0, 1].

    Per-face bounding-box barycentric fill — O(F * bbox) host work, run
    once per shard.  White background; foreground color = world normal
    mapped to RGB (n * 0.5 + 0.5), which carries dense geometry
    information for the image encoder.
    """
    homo = np.concatenate(
        [verts, np.ones((verts.shape[0], 1), verts.dtype)], axis=1
    )
    proj = homo @ cam_4x4.astype(verts.dtype)
    z = proj[:, 2]
    z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    sx = (proj[:, 0] / z + 1.0) * 0.5 * width - 0.5
    sy = (proj[:, 1] / z + 1.0) * 0.5 * height - 0.5

    tri_w = verts[faces]
    n = np.cross(tri_w[:, 1] - tri_w[:, 0], tri_w[:, 2] - tri_w[:, 0])
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    colors = (n * 0.5 + 0.5).astype(np.float32)

    zbuf = np.full((height, width), np.inf, np.float64)
    img = np.ones((height, width, 3), np.float32)

    fx, fy, fz = sx[faces], sy[faces], z[faces]  # (F, 3)
    in_front = np.all(fz > 1e-6, axis=1)
    for i in np.nonzero(in_front)[0]:
        x0 = max(int(np.floor(fx[i].min())), 0)
        x1 = min(int(np.ceil(fx[i].max())) + 1, width)
        y0 = max(int(np.floor(fy[i].min())), 0)
        y1 = min(int(np.ceil(fy[i].max())) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1, dtype=np.float64)[None, :]
        ys = np.arange(y0, y1, dtype=np.float64)[:, None]
        ax, ay = fx[i, 0], fy[i, 0]
        bx, by = fx[i, 1], fy[i, 1]
        cx, cy = fx[i, 2], fy[i, 2]
        d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(d) < 1e-12:
            continue
        w0 = ((by - cy) * (xs - cx) + (cx - bx) * (ys - cy)) / d
        w1 = ((cy - ay) * (xs - cx) + (ax - cx) * (ys - cy)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z in screen space
        inv_z = w0 / fz[i, 0] + w1 / fz[i, 1] + w2 / fz[i, 2]
        depth = 1.0 / np.maximum(inv_z, 1e-12)
        tile = zbuf[y0:y1, x0:x1]
        win = inside & (depth < tile)
        tile[win] = depth[win]
        img[y0:y1, x0:x1][win] = colors[i]
    return img


def views(params: dict, seed: int):
    """(images (S, V, R, R, 3) float32, cameras (S, V, 4, 4) float32):
    ``n_views`` renders at ``image_res`` of each of the cell's shapes
    (``traffic.shape_ids``), each shape's cameras from its own
    generator."""
    n_views, res = int(params["n_views"]), int(params["image_res"])
    imgs, cams = [], []
    for i, sid in enumerate(shape_ids(params, seed)):
        verts, faces = random_shape(sid, level=int(params["level"]))
        rng = np.random.default_rng([seed, i, 1409])
        cam = [random_camera(rng) for _ in range(n_views)]
        imgs.append([render_mesh_image(verts.astype(np.float32), faces, c,
                                       res, res) for c in cam])
        cams.append(cam)
    return np.asarray(imgs, np.float32), np.asarray(cams, np.float32)
