"""Wavefront OBJ IO (numpy; the port's copy of deftet_tpu/utils/objio.py).

Supports v/f records with 1-based, optionally slash-qualified indices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as f:
        for v in verts:
            f.write("v %f %f %f\n" % (v[0], v[1], v[2]))
        for tri in faces + 1:
            f.write("f %d %d %d\n" % (tri[0], tri[1], tri[2]))


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                # fan-triangulate polygons
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces, dtype=np.int32),
    )
