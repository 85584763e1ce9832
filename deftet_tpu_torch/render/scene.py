"""Optimizable tet scene for 2D-supervision reconstruction (torch port of
deftet_tpu/render/scene.py; the reference's 3_model/deftet.py).

A tet grid whose per-vertex offsets (``mov``) and RGBA feature logits
(``feat``) are optimized.  Parameters are a dict of tensors
``{"mov", "feat"}`` on the scene's device; the topology (tets, render
faces, vertex adjacency, tet neighbours) lives on the host as numpy and
is rebuilt on carving and subdivision, with device copies made on demand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..tetgrid.grid import TetGrid
from ..tetgrid.subdivide import subdivide_tets
from ..tetgrid.topology import (
    build_faces,
    build_tet_neighbors,
    build_vertex_adjacency,
    hull_face_owners,
)
from .camera import perspective
from .composite import render_mesh_color


def build_render_faces(tets: np.ndarray, n_point: int) -> np.ndarray:
    """All unique faces of a tet list, interior then hull (the reference
    renders the deduplicated face set with the boundary)."""
    face_fx3, _, _, hull = build_faces(tets, n_point)
    return np.concatenate([face_fx3, hull], axis=0).astype(np.int32)


def _sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def params_numpy(params) -> Dict[str, np.ndarray]:
    """Host float32 copies of a parameter dict."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in params.items()}


@dataclasses.dataclass
class TetScene:
    """Host-side scene state plus device copies of its topology."""

    points_px3: np.ndarray        # (P, 3) base vertex positions (fixed)
    tets_tx4: np.ndarray          # (T, 4) alive tets
    coef: float = 2.5             # world scale
    feat_dim: int = 4             # [alpha, r, g, b]
    device: object = "cuda"

    # derived (filled by refresh_topology)
    faces_fx3: np.ndarray = None
    adj_idx: np.ndarray = None
    adj_mask: np.ndarray = None
    adj_deg: np.ndarray = None
    tet_neighbor_tx4: np.ndarray = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.refresh_topology()

    @classmethod
    def from_grid(cls, grid: TetGrid, coef: float = 2.5, feat_dim: int = 4,
                  device="cuda"):
        return cls(points_px3=grid.centered_vertices().astype(np.float32),
                   tets_tx4=np.asarray(grid.tets, dtype=np.int32),
                   coef=coef, feat_dim=feat_dim, device=device)

    @property
    def n_points(self) -> int:
        return int(self.points_px3.shape[0])

    @property
    def n_tets(self) -> int:
        return int(self.tets_tx4.shape[0])

    def refresh_topology(self) -> None:
        n = self.n_points
        self._dev: Dict[str, torch.Tensor] = {}
        self.faces_fx3 = build_render_faces(self.tets_tx4, n)
        self.adj_idx, self.adj_mask, self.adj_deg = build_vertex_adjacency(
            self.tets_tx4, n)
        _, face_tet, face_slot, _ = build_faces(self.tets_tx4, n)
        self.tet_neighbor_tx4 = build_tet_neighbors(face_tet, face_slot,
                                                    self.n_tets)

    def tensor(self, name: str) -> torch.Tensor:
        """Device copy of a host array of the scene (cached until the
        topology changes)."""
        t = self._dev.get(name)
        if t is None:
            arr = getattr(self, name)
            dtype = torch.long if arr.dtype.kind == "i" else torch.float32
            t = self._dev[name] = torch.as_tensor(arr, dtype=dtype,
                                                  device=self.device)
        return t

    # ------------------------------------------------------------------
    def init_params(self) -> Dict[str, torch.Tensor]:
        """Zero offsets and zero feature logits (alpha 0.5)."""
        return {
            "mov": torch.zeros((self.n_points, 3), device=self.device),
            "feat": torch.zeros((self.n_points, self.feat_dim),
                                device=self.device),
        }

    def world_points(self, params) -> torch.Tensor:
        """coef * (base + mov)."""
        return self.coef * (self.tensor("points_px3") + params["mov"])

    def face_arrays(self, params, rot, pos, proj):
        """(face_z (F, 3), face_img (F, 3, 2), face_feat (F, 3, C)) of one
        view, features after the sigmoid: the inputs of a full frame."""
        cam, xy = perspective(self.world_points(params)[None],
                              *self._camera(rot, pos, proj))
        faces = self.tensor("faces_fx3")
        return (cam[0, :, 2][faces], xy[0][faces],
                torch.sigmoid(params["feat"])[faces])

    def _camera(self, rot, pos, proj):
        return tuple(torch.as_tensor(x, dtype=torch.float32,
                                     device=self.device)
                     for x in (rot, pos, proj))

    # ------------------------------------------------------------------
    def save_state(self, path: str, params) -> None:
        """Topology and parameters in one npz (the JAX package's format)."""
        p = params_numpy(params)
        np.savez(path, points=self.points_px3, tets=self.tets_tx4,
                 coef=np.float32(self.coef), feat_dim=np.int32(self.feat_dim),
                 feat=p["feat"], mov=p["mov"])

    @classmethod
    def load_state(cls, path: str, device="cuda"):
        """(scene, params) from a ``save_state`` npz (either package's)."""
        with np.load(path) as z:
            scene = cls(points_px3=z["points"].astype(np.float32),
                        tets_tx4=z["tets"].astype(np.int32),
                        coef=float(z["coef"]), feat_dim=int(z["feat_dim"]),
                        device=device)
            params = {
                "feat": torch.as_tensor(z["feat"].astype(np.float32),
                                        device=scene.device),
                "mov": torch.as_tensor(z["mov"].astype(np.float32),
                                       device=scene.device),
            }
        return scene, params

    # ------------------------------------------------------------------
    def render(self, params, pixel_xy_1xpx2, cam_rot_bx3x3, cam_pos_bx3,
               cam_proj_3, k: int = 10, depth: bool = False,
               chunk: int = 1024, pixel_chunk: int = 2048,
               bin_cand: int = -1, bin_sort: bool = True):
        """Render sampled pixels: (color, mask, depth or None).  The z
        range is (-1000, 0): the camera looks down -z.  ``bin_cand`` -1
        is the automatic budget (F // 4 rounded up to 512, within
        [2048, 65536]; off when it reaches F); 0 is off."""
        rot, pos, proj = self._camera(cam_rot_bx3x3, cam_pos_bx3, cam_proj_3)
        pix = torch.as_tensor(pixel_xy_1xpx2, dtype=torch.float32,
                              device=self.device)
        b = rot.shape[0]
        pts = self.world_points(params)[None].expand(b, -1, -1)
        feat = params["feat"][None].expand(b, -1, -1)
        cam_pts, img_xy = perspective(pts, rot, pos, proj)
        ranges = torch.cat([torch.full_like(pix[..., :1], -1000.0),
                            torch.zeros_like(pix[..., :1])], dim=-1)
        if bin_cand < 0:
            f = int(self.faces_fx3.shape[0])
            bin_cand = min(max(-(-(f // 4) // 512) * 512, 2048), 65536)
            if bin_cand >= f:
                bin_cand = 0
        return render_mesh_color(pix, ranges, cam_pts, img_xy, feat,
                                 self.tensor("faces_fx3"), k=k, depth=depth,
                                 chunk=chunk, pixel_chunk=pixel_chunk,
                                 bin_cand=bin_cand, bin_sort=bin_sort)

    # ------------------------------------------------------------------
    def feature_laplacian(self, x_pxd: torch.Tensor) -> torch.Tensor:
        """Squared difference between each vertex value and the mean of
        its tet-edge neighbours."""
        gathered = x_pxd[self.tensor("adj_idx")]            # (P, M, D)
        s = torch.sum(gathered * self.tensor("adj_mask")[..., None], dim=1)
        deg = self.tensor("adj_deg").clamp_min(1).to(x_pxd.dtype)
        return (s / deg[:, None] - x_pxd) ** 2

    def tet_weights(self, point_weights_p: np.ndarray) -> np.ndarray:
        """Max vertex weight per tet."""
        return point_weights_p[self.tets_tx4].max(axis=1)

    def dilate_tet_weights(self, w_t: np.ndarray, levels: int = 1):
        """Max-dilate tet weights over face-sharing neighbours."""
        w = w_t.copy()
        for _ in range(levels):
            padded = np.concatenate([[0.0], w])
            w = np.maximum(w, padded[self.tet_neighbor_tx4 + 1].max(axis=1))
        return w

    def _alpha(self, params) -> np.ndarray:
        return _sigmoid_np(params_numpy(params)["feat"][:, 0])

    def carve(self, params, threshold: float = 0.01,
              neighbor_levels: int = 1) -> bool:
        """Delete tets whose dilated max vertex alpha is at or below
        ``threshold``.  Returns True if the topology changed; keeps
        everything when carving would empty the scene."""
        w_t = self.dilate_tet_weights(self.tet_weights(self._alpha(params)),
                                      neighbor_levels)
        keep = w_t > threshold
        if not keep.any() or keep.all():
            return False
        self.tets_tx4 = self.tets_tx4[keep]
        self.refresh_topology()
        return True

    def save_surface_obj(self, params, path: str,
                         threshold: float = 0.4) -> int:
        """Export the occupied region's surface with vertex colours ('v x y
        z r g b'): faces between occupied and empty tets, oriented
        outward, plus occupied hull faces.  Occupancy per tet = max vertex
        alpha > threshold.  Returns the face count."""
        p = params_numpy(params)
        feat = _sigmoid_np(p["feat"])
        alpha, rgb = feat[:, 0], feat[:, 1:4]
        occ_t = alpha[self.tets_tx4].max(axis=1) > threshold
        face_fx3, face_tet, _, hull = build_faces(self.tets_tx4,
                                                  self.n_points)
        occ_a = occ_t[face_tet[:, 0]]
        boundary = occ_a != occ_t[face_tet[:, 1]]
        keep = face_fx3[boundary]
        flip = occ_a[boundary]  # the first owner is the occupied one
        keep[flip] = keep[flip][:, ::-1]
        if hull.shape[0]:
            owners = hull_face_owners(self.tets_tx4, hull, self.n_points)
            faces_out = np.concatenate(
                [keep, hull[occ_t[owners]][:, ::-1]], axis=0)
        else:
            faces_out = keep
        verts = self.coef * (self.points_px3 + p["mov"])
        with open(path, "w") as f:
            for v, c in zip(verts, rgb):
                f.write("v %f %f %f %f %f %f\n"
                        % (v[0], v[1], v[2], c[0], c[1], c[2]))
            for tri in faces_out + 1:
                f.write("f %d %d %d\n" % (tri[0], tri[1], tri[2]))
        return int(faces_out.shape[0])

    def subdivide(self, params, threshold: Optional[float] = None):
        """1->8 subdivision of every tet (or of those whose min vertex
        alpha is below ``threshold``); mov and feat are midpoint
        interpolated.  Returns the new parameter dict."""
        p = params_numpy(params)
        flag = None
        if threshold is not None:
            flag = _sigmoid_np(p["feat"][:, 0])[self.tets_tx4].min(
                axis=1) < threshold
        new_points, new_feats, new_tets = subdivide_tets(
            self.tets_tx4, self.points_px3,
            np.concatenate([p["feat"], p["mov"]], axis=1), flag)
        self.points_px3 = new_points.astype(np.float32)
        self.tets_tx4 = new_tets
        self.refresh_topology()
        d = self.feat_dim
        return {
            "feat": torch.as_tensor(new_feats[:, :d].astype(np.float32),
                                    device=self.device),
            "mov": torch.as_tensor(new_feats[:, d:].astype(np.float32),
                                   device=self.device),
        }
