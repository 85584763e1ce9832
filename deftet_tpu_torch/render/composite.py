"""Alpha compositing of peeled layers and the full render path (torch
port of deftet_tpu/render/composite.py: peel2mask and rendermeshcolor of
the reference's 5_rendereq/deftetrneder.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .raster import deftet_sparse_render

EPS = 1e-10


def peel2mask(ims_bxpxkxd: torch.Tensor,
              imdepth_bxpxkx1: Optional[torch.Tensor] = None):
    """Composite k peeled [alpha, rgb...] layers front to back over a white
    background.  Returns (color (B, P, D-1), visibility (B, P, 1), depth
    (B, P, 1) or None; background depth -6)."""
    alpha = ims_bxpxkxd[..., :1].clamp(EPS, 1.0 - EPS)
    color = ims_bxpxkxd[..., 1:]
    # (1 - alpha) shifted one layer back; the front layer sees 1
    shifted = F.pad(1.0 - alpha[:, :, :-1, :], (0, 0, 1, 0), value=1.0)
    vis = alpha * torch.cumprod(shifted, dim=2)
    out_color = torch.sum(color * vis, dim=2)
    out_depth = (torch.sum(imdepth_bxpxkx1 * vis, dim=2)
                 if imdepth_bxpxkx1 is not None else None)
    out_vis = torch.sum(vis, dim=2)
    out_color = out_color + (1.0 - out_vis)
    if out_depth is not None:
        out_depth = out_depth + -6.0 * (1.0 - out_vis)
    return out_color, out_vis, out_depth


def vertex2face(vert_bxpxd: torch.Tensor, faces_fx3: torch.Tensor):
    """(B, N, D) vertex data -> (B, F, 3, D) per-face corner data."""
    return vert_bxpxd[:, faces_fx3.long()]


def render_mesh_color(
    pixel_xy_1xpx2: torch.Tensor,
    pixel_range_1xpx2: torch.Tensor,
    points3d_bxpx3: torch.Tensor,
    points2d_bxpx2: torch.Tensor,
    feat_bxpxd: torch.Tensor,
    faces_fx3: torch.Tensor,
    k: int = 30,
    depth: bool = False,
    chunk: int = 1024,
    pixel_chunk: int = 8192,
    bin_cand: int = 0,
    bin_sort: bool = True,
):
    """Per-vertex RGBA logits -> composited image: (color (B, P, D-2 or
    D-1), mask (B, P, 1), depth or None).  Features pass through a
    sigmoid; with ``depth`` the first rendered channel is camera z."""
    feat = torch.sigmoid(feat_bxpxd)
    if depth:
        feat = torch.cat([points3d_bxpx3[..., 2:3], feat], dim=-1)
    face_z = vertex2face(points3d_bxpx3[..., 2:3], faces_fx3)[..., 0]
    face_img = vertex2face(points2d_bxpx2, faces_fx3)
    face_feat = vertex2face(feat, faces_fx3)
    layers, _ = deftet_sparse_render(
        pixel_xy_1xpx2, pixel_range_1xpx2, face_z, face_img, face_feat,
        k=k, chunk=chunk, pixel_chunk=pixel_chunk, bin_cand=bin_cand,
        bin_sort=bin_sort,
    )
    im_depth = None
    if depth:
        im_depth, layers = layers[..., :1], layers[..., 1:]
    return peel2mask(layers, im_depth)
