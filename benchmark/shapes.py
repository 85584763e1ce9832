"""Procedural watertight triangle meshes (numpy, host-side): a frozen copy
of the port's ``data/shapes.py``, the benchmark's shape family.

A self-contained stand-in for ShapeNet: every generator returns a closed,
consistently-oriented mesh normalized the same way the reference normalizes
ShapeNet models (longest axis scaled to ``max_length`` and centered,
dataloader.py:26-32), so the rest of the pipeline (surface sampling, SDF
labeling, occupancy supervision) is identical.
"""

from __future__ import annotations

import numpy as np


def normalize_mesh(
    verts: np.ndarray, max_length: float = 0.9
) -> np.ndarray:
    """Scale longest axis to max_length and center (dataloader.py:26-32)."""
    max_l = (verts.max(axis=0) - verts.min(axis=0)).max()
    verts = verts / max_l * max_length
    mid = (verts.max(axis=0) + verts.min(axis=0)) / 2
    return verts - mid


def icosphere(level: int = 3):
    """Subdivided icosahedron on the unit sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(level):
        n = verts.shape[0]
        e = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
        )
        key = e.min(1) * (n + 1) + e.max(1)
        uniq, inv = np.unique(key, return_inverse=True)
        mids = np.zeros((uniq.shape[0], 3))
        lo = (uniq // (n + 1)).astype(np.int64)
        hi = (uniq % (n + 1)).astype(np.int64)
        mids = (verts[lo] + verts[hi]) / 2
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = inv.reshape(3, -1).T + n  # (F, 3): m01, m12, m20
        v0, v1, v2 = faces.T
        m01, m12, m20 = mid_idx.T
        faces = np.concatenate(
            [
                np.stack([v0, m01, m20], 1),
                np.stack([v1, m12, m01], 1),
                np.stack([v2, m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ],
            axis=0,
        )
        verts = np.concatenate([verts, mids], axis=0)
    return verts, faces


def make_blob(rng: np.random.Generator, level: int = 3, n_bumps: int = 6,
              amp: float = 0.35):
    """Star-shaped random blob: icosphere with smooth radial bumps —
    watertight by construction."""
    verts, faces = icosphere(level)
    dirs = rng.normal(size=(n_bumps, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    amps = rng.uniform(-amp, amp, size=n_bumps)
    widths = rng.uniform(2.0, 8.0, size=n_bumps)
    radial = np.ones(verts.shape[0]) + sum(
        a * np.exp(-w * (1.0 - verts @ d)) for a, w, d in zip(amps, widths, dirs)
    )
    radial = np.clip(radial, 0.3, None)
    return normalize_mesh(verts * radial[:, None]), faces


def make_ellipsoid(rng: np.random.Generator, level: int = 3):
    verts, faces = icosphere(level)
    scale = rng.uniform(0.35, 1.0, size=3)
    return normalize_mesh(verts * scale), faces


def make_box(rng: np.random.Generator, n: int = 6):
    """Triangulated box surface with an n x n grid per side (watertight)."""
    half = rng.uniform(0.3, 1.0, size=3)
    lin = np.linspace(-1.0, 1.0, n + 1)
    verts_list, faces_list = [], []
    offset = 0
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u, v = np.meshgrid(lin, lin, indexing="ij")
            flat = np.zeros(((n + 1) ** 2, 3))
            other = [a for a in range(3) if a != axis]
            flat[:, other[0]] = u.ravel()
            flat[:, other[1]] = v.ravel()
            flat[:, axis] = sign
            verts_list.append(flat * half)
            ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            q00 = (ii * (n + 1) + jj).ravel() + offset
            q01 = q00 + 1
            q10 = q00 + (n + 1)
            q11 = q10 + 1
            if sign * (1 if axis != 1 else -1) > 0:
                f = np.concatenate(
                    [np.stack([q00, q10, q11], 1), np.stack([q00, q11, q01], 1)]
                )
            else:
                f = np.concatenate(
                    [np.stack([q00, q11, q10], 1), np.stack([q00, q01, q11], 1)]
                )
            faces_list.append(f)
            offset += (n + 1) ** 2
    verts = np.concatenate(verts_list, axis=0)
    faces = np.concatenate(faces_list, axis=0)
    # weld duplicate edge/corner vertices so the mesh is watertight
    key = np.round(verts, 6)
    _, idx_map, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[idx_map]
    faces = inverse[faces]
    return normalize_mesh(verts), faces.astype(np.int64)


def make_torus(rng: np.random.Generator, n_u: int = 48, n_v: int = 24):
    big_r = rng.uniform(0.6, 1.0)
    small_r = rng.uniform(0.15, 0.45) * big_r
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (big_r + small_r * np.cos(vv)) * np.cos(uu)
    y = (big_r + small_r * np.cos(vv)) * np.sin(uu)
    z = small_r * np.sin(vv)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    ii, jj = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    q00 = (ii * n_v + jj).ravel()
    q01 = (ii * n_v + (jj + 1) % n_v).ravel()
    q10 = (((ii + 1) % n_u) * n_v + jj).ravel()
    q11 = (((ii + 1) % n_u) * n_v + (jj + 1) % n_v).ravel()
    faces = np.concatenate(
        [np.stack([q00, q10, q11], 1), np.stack([q00, q11, q01], 1)], axis=0
    )
    return normalize_mesh(verts), faces.astype(np.int64)


_FAMILIES = ("blob", "ellipsoid", "box", "torus")


def shape_family(seed: int) -> str:
    """Category name of random_shape(seed) (round-robin by seed)."""
    return _FAMILIES[seed % len(_FAMILIES)]


def random_shape(seed: int, level: int = 3):
    """Deterministic random watertight mesh; family round-robins by seed."""
    rng = np.random.default_rng(seed)
    family = _FAMILIES[seed % len(_FAMILIES)]
    if family == "blob":
        return make_blob(rng, level=level)
    if family == "ellipsoid":
        return make_ellipsoid(rng, level=level)
    if family == "box":
        return make_box(rng)
    return make_torus(rng)
