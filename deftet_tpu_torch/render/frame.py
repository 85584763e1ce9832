"""Full-frame rendering over exact per-tile candidate lists (torch port of
the exact part of deftet_tpu/render/frame.py).

  host   — project the faces (numpy), and list for each 16x16 screen tile
           every face whose eps-expanded screen bbox overlaps the tile's
           pixel centres (``build_frame_bins``, CSR, ascending ids);
  device — one ``raster_hit`` call over every tile at the peel depth
           ``k``, which also returns each pixel's exact hit count; the
           replay then composites only the first ``k_eff`` layers, the
           smallest power of two (at least 8, at most ``k``) holding every
           pixel's hits, so the frame equals a render at depth ``k``.

Each candidate list is exact by construction (a superset of the faces
that can cover the tile), so a frame equals an unbinned render of every
pixel at depth ``k``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .composite import peel2mask
from .raster import barycentric_2d, raster_hit

# host and device projections of a face can differ by rounding; bboxes
# grow by this NDC margin so the host cull stays a superset of what the
# device hit test accepts (1e-5 NDC = 1/500 px at 400^2)
_BBOX_EPS = 1e-5


def tile_pixel_layout(h: int, w: int, tile: int):
    """(pix_idx (T, tile*tile) int32 linear pixel indices, (ny, nx)): edge
    tiles are padded by repeating their last pixel (assembly writes the
    same value twice)."""
    ny, nx = -(-h // tile), -(-w // tile)
    out = np.empty((ny * nx, tile * tile), np.int32)
    for ty in range(ny):
        ys = np.arange(ty * tile, min((ty + 1) * tile, h))
        for tx in range(nx):
            xs = np.arange(tx * tile, min((tx + 1) * tile, w))
            lin = (ys[:, None] * w + xs[None, :]).reshape(-1)
            if lin.size < tile * tile:
                lin = np.concatenate(
                    [lin, np.full(tile * tile - lin.size, lin[-1], np.int32)])
            out[ty * nx + tx] = lin
    return out, (ny, nx)


def build_frame_bins(face_img_fx3x2: np.ndarray, h: int, w: int,
                     tile: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-tile candidate lists of an (h, w) frame, every tile in
    row-major tile order (empty lists included), as CSR: (offsets (T+1,)
    int64, cand (N,) int32 ascending within each tile).  A face is listed
    for each tile whose pixel-centre grid meets its bbox grown by
    ``_BBOX_EPS``; faces off the pixel grid are dropped."""
    fmin = face_img_fx3x2.min(axis=1) - _BBOX_EPS
    fmax = face_img_fx3x2.max(axis=1) + _BBOX_EPS
    ny, nx = -(-h // tile), -(-w // tile)
    # pixel centres: x_i = (i + .5) / w * 2 - 1, y_j = -((j + .5) / h * 2 - 1)
    ix0 = np.ceil((fmin[:, 0] + 1.0) * 0.5 * w - 0.5)
    ix1 = np.floor((fmax[:, 0] + 1.0) * 0.5 * w - 0.5)
    iy0 = np.ceil((1.0 - fmax[:, 1]) * 0.5 * h - 0.5)
    iy1 = np.floor((1.0 - fmin[:, 1]) * 0.5 * h - 0.5)
    on = (ix1 >= 0) & (ix0 <= w - 1) & (iy1 >= 0) & (iy0 <= h - 1)
    on &= (ix0 <= ix1) & (iy0 <= iy1)
    tx0 = (np.clip(ix0, 0, w - 1)[on] // tile).astype(np.int64)
    tx1 = (np.clip(ix1, 0, w - 1)[on] // tile).astype(np.int64)
    ty0 = (np.clip(iy0, 0, h - 1)[on] // tile).astype(np.int64)
    ty1 = (np.clip(iy1, 0, h - 1)[on] // tile).astype(np.int64)
    fid = np.nonzero(on)[0].astype(np.int64)

    # expand (face, covered tile rectangle) into (tile, face) pairs
    nx_span = tx1 - tx0 + 1
    span = (nx_span * (ty1 - ty0 + 1)).astype(np.int64)
    rep = np.repeat(np.arange(fid.shape[0]), span)
    off = np.arange(int(span.sum())) - np.repeat(np.cumsum(span) - span, span)
    tidx = (ty0[rep] + off // nx_span[rep]) * nx + (tx0[rep] + off %
                                                    nx_span[rep])
    # one packed-key sort orders the pairs by tile, then by face
    n_faces = np.int64(face_img_fx3x2.shape[0])
    key = tidx * n_faces + fid[rep]
    key.sort()
    counts = np.bincount(key // n_faces, minlength=ny * nx)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, (key % n_faces).astype(np.int32)


def frame_pixels(h: int, w: int, tile: int):
    """(lin (T*tile*tile,) linear pixel index, pix (T*tile*tile, 2) NDC
    centres) in tile order: the pixel layout of ``frame_hits``."""
    from .optimize import pixel_grid

    pix_idx, _ = tile_pixel_layout(h, w, tile)
    lin = pix_idx.reshape(-1)
    return lin, pixel_grid(h, w)[lin]


def frame_hits(face_z_fx3, face_img_fx3x2, bins, pix_np, tile: int, k: int,
               z_range=(-1000.0, 0.0), chunk: int = 1024):
    """The hit pass of a frame: (ids (P, k), counts (P,)) over the tiles'
    candidate lists ``bins`` (``build_frame_bins``)."""
    dev = face_z_fx3.device
    offsets, cand = bins
    pix = torch.as_tensor(pix_np, device=dev)
    ranges = torch.tensor(z_range, dtype=torch.float32,
                          device=dev).expand(pix.shape[0], 2)
    ids, _, counts = raster_hit(
        pix, ranges.contiguous(), face_z_fx3, face_img_fx3x2,
        torch.as_tensor(cand, device=dev), torch.as_tensor(offsets,
                                                           device=dev),
        tile * tile, k, chunk)
    return ids, counts


def peel_depth(counts, k: int) -> int:
    """The replay depth of a frame: the smallest power of two (at least 8)
    holding every pixel's hits, capped at ``k``."""
    most = int(counts.max()) if counts.numel() else 0
    return min(max(8, 1 << (max(most, 1) - 1).bit_length()), k)


@torch.no_grad()
def frame_replay(ids_pxk, pix_np, face_img_fx3x2, face_feat_fx3xc,
                 chunk_pixels: int = 16384):
    """Composite each pixel's peeled layers: (color (P, C-1), vis (P, 1))
    over a white background, ``chunk_pixels`` pixels at a time."""
    pix_all = torch.as_tensor(pix_np, device=ids_pxk.device)
    colors, vis = [], []
    for s in range(0, ids_pxk.shape[0], chunk_pixels):
        idx = ids_pxk[s:s + chunk_pixels]
        safe = idx.clamp_min(0).long()
        w0, w1, w2 = barycentric_2d(pix_all[s:s + chunk_pixels, None, :],
                                    face_img_fx3x2[safe])
        f = face_feat_fx3xc[safe]                        # (p, k, 3, C)
        feat = (w0[..., None] * f[..., 0, :] + w1[..., None] * f[..., 1, :]
                + w2[..., None] * f[..., 2, :])
        feat = torch.where((idx >= 0)[..., None], feat,
                           torch.zeros_like(feat))
        c, v, _ = peel2mask(feat[None])
        colors.append(c[0])
        vis.append(v[0])
    return torch.cat(colors), torch.cat(vis)


def render_frame(face_z_fx3, face_img_fx3x2, face_feat_fx3xc,
                 face_img_np: np.ndarray, h: int, w: int, k: int = 120,
                 chunk: int = 1024, tile: int = 16,
                 z_range=(-1000.0, 0.0)):
    """Render a full (h, w) frame: (color (h, w, C-1), vis (h, w, 1)) numpy
    and the peel depth used.  ``face_*`` are device tensors (features
    after the sigmoid, [alpha, rgb...]); ``face_img_np`` is the host
    projection of the same faces, used only to build the lists."""
    c_dim = int(face_feat_fx3xc.shape[-1]) - 1
    bins = build_frame_bins(face_img_np, h, w, tile)
    lin, pix = frame_pixels(h, w, tile)
    ids, counts = frame_hits(face_z_fx3, face_img_fx3x2, bins, pix, tile, k,
                             z_range, chunk)
    k_used = peel_depth(counts, k)
    c, v = frame_replay(ids[:, :k_used], pix, face_img_fx3x2,
                        face_feat_fx3xc)
    color = np.ones((h * w, c_dim), np.float32)  # white background
    vis = np.zeros((h * w, 1), np.float32)
    color[lin] = c.cpu().numpy()
    vis[lin] = v.cpu().numpy()
    return color.reshape(h, w, c_dim), vis.reshape(h, w, 1), k_used
