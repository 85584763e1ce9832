"""Topology edits between optimization stages (numpy; copy of
deftet_tpu/tetgrid/subdivide.py): occupancy carving and 1->8 subdivision
with one midpoint per unique edge."""

from __future__ import annotations

import numpy as np

from .topology import TET_EDGES


def delete_tets(
    tets: np.ndarray, vert_weights: np.ndarray, threshold: float = 0.01
) -> np.ndarray:
    """Keep tets whose maximum per-vertex weight exceeds ``threshold``."""
    return tets[vert_weights[tets].max(axis=1) > threshold]


def _unique_edges(tets: np.ndarray, n_point: int):
    e = tets[:, TET_EDGES].reshape(-1, 2).astype(np.int64)
    uniq_key = np.unique(e.min(axis=1) * n_point + e.max(axis=1))
    edges = np.stack([uniq_key // n_point, uniq_key % n_point], axis=1)
    return edges, uniq_key


def subdivide_tets(
    tets: np.ndarray,
    points: np.ndarray,
    feats: np.ndarray | None = None,
    subdivide_flag: np.ndarray | None = None,
):
    """1->8 subdivision with midpoint vertices on every unique edge.

    ``feats`` (P, K) are midpoint-averaged like the points.  With
    ``subdivide_flag`` (T,) only flagged tets are split; the rest are kept
    whole (a non-conforming interface).  Returns (new_points, new_feats,
    new_tets int32): unflagged tets first, then the children of each split
    tet in the order (a, ab, ac, ad), (b, bc, ab, bd), (c, ac, bc, cd),
    (d, ad, cd, bd) and the four of the inner octahedron.
    """
    tets = np.asarray(tets, dtype=np.int64)
    points = np.asarray(points)
    n_point = points.shape[0]
    edges, uniq_key = _unique_edges(tets, n_point)

    mid_points = (points[edges[:, 0]] + points[edges[:, 1]]) / 2.0
    new_points = np.concatenate([points, mid_points], axis=0)
    new_feats = None
    if feats is not None:
        mid_feats = (feats[edges[:, 0]] + feats[edges[:, 1]]) / 2.0
        new_feats = np.concatenate([feats, mid_feats], axis=0)

    # per-tet midpoint indices in TET_EDGES order (ab, ac, ad, bc, bd, cd)
    e = tets[:, TET_EDGES]
    key = e.min(axis=2) * n_point + e.max(axis=2)
    edge_idx = np.searchsorted(uniq_key, key) + n_point

    a, b, c, d = tets.T
    ab, ac, ad, bc, bd, cd = edge_idx.T
    children = np.stack(
        [
            np.stack([a, ab, ac, ad], axis=1),
            np.stack([b, bc, ab, bd], axis=1),
            np.stack([c, ac, bc, cd], axis=1),
            np.stack([d, ad, cd, bd], axis=1),
            np.stack([ab, ac, ad, bd], axis=1),
            np.stack([ab, ac, bd, bc], axis=1),
            np.stack([cd, ac, bd, ad], axis=1),
            np.stack([cd, ac, bc, bd], axis=1),
        ],
        axis=1,
    )  # (T, 8, 4)

    if subdivide_flag is None:
        new_tets = children.reshape(-1, 4)
    else:
        flag = np.asarray(subdivide_flag, dtype=bool)
        new_tets = np.concatenate(
            [tets[~flag], children[flag].reshape(-1, 4)], axis=0
        )
    return new_points, new_feats, new_tets.astype(np.int32)
