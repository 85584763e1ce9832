"""Depth-peeled differentiable rasterizer (torch port of
deftet_tpu/render/raster.py; kaolin's ``deftet_sparse_render``).

  inputs : pixel coords (1, P, 2), per-pixel z ranges (1, P, 2), face
           vertex z (B, F, 3), face vertex image xy (B, F, 3, 2), face
           vertex features (B, F, 3, C), peel depth k
  output : (B, P, k, C) features of the k nearest faces covering each
           pixel (nearest = largest camera z first), and (B, P, k) face
           ids (-1 = none).

Two passes, as in the JAX package:

* the hit pass (no autograd): per pixel, the ids of the k nearest
  covering faces and the exact number of covering faces.  ``raster_hit``
  runs it over consecutive pixel tiles, each with one candidate list of
  face ids (CSR: ``cand[offsets[t]:offsets[t + 1]]``, entries of -1
  skipped).  On a CUDA tensor it launches ``csrc/raster_hit.cu``; on a CPU
  tensor it runs ``raster_hit_plain``, a scan over candidate chunks that
  merges each chunk into the running k best with a stable sort.  Both
  order hits by z descending and, on equal z, by list position (with
  ascending lists: the lower face id first), and agree bit for bit.
* the differentiable replay: gather the chosen faces and recompute the
  barycentric weights and the interpolated features in autograd, so
  gradients reach face z, image xy and features with no backward kernel.

Screen-space binning (``bin_cand`` > 0): pixels are sorted into raster
order (or kept in the caller's order with ``bin_sort=False``), cut into
``pixel_chunk`` tiles, and each tile scans only the (at most
``bin_cand``, lowest ids first) faces whose screen bbox overlaps its
pixels' bbox; exact while no tile overflows (``bin_overflow``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda

_NEG = -1.0e10
_KERNEL = "raster_hit"
# elements of one (pixels, k + chunk) merge buffer in the plain scan
_PLAIN_ELEMS = 1 << 24


def _edge(ax, ay, bx, by, px, py):
    """2D cross product (b - a) x (p - a)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def barycentric_2d(pix_xy, tri_xy, eps: float = 1e-12):
    """Barycentric weights (w0, w1, w2) of pixels (..., 2) in triangles
    (..., 3, 2), broadcast against each other."""
    ax, ay = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    bx, by = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    cx, cy = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    px, py = pix_xy[..., 0], pix_xy[..., 1]
    denom = _edge(ax, ay, bx, by, cx, cy)
    denom_safe = torch.where(denom.abs() < eps, torch.ones_like(denom), denom)
    w2 = _edge(ax, ay, bx, by, px, py) / denom_safe
    w0 = _edge(bx, by, cx, cy, px, py) / denom_safe
    w1 = 1.0 - w0 - w2
    return w0, w1, w2


# ----------------------------------------------------------- the hit pass
def _scan_tiles(pix_txqx2, range_txqx2, face_z_fx3, face_img_fx3x2,
                cand_txn, chunk: int, k: int):
    """Plain hit scan of T tiles of Q pixels, each over its own -1-padded
    candidate list (T, n).  Returns (z (T, Q, k), ids (T, Q, k),
    counts (T, Q))."""
    t, q = pix_txqx2.shape[:2]
    dev = pix_txqx2.device
    best_z = torch.full((t, q, k), _NEG, dtype=torch.float32, device=dev)
    best_i = torch.full((t, q, k), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((t, q), dtype=torch.int32, device=dev)
    lo, hi = range_txqx2[..., 0:1], range_txqx2[..., 1:2]
    for s in range(0, cand_txn.shape[1], chunk):
        idc = cand_txn[:, s:s + chunk]                    # (T, C)
        safe = idc.clamp_min(0).long()
        zc = face_z_fx3[safe][:, None]                    # (T, 1, C, 3)
        w0, w1, w2 = barycentric_2d(pix_txqx2[:, :, None, :],
                                    face_img_fx3x2[safe][:, None])
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        z = w0 * zc[..., 0] + w1 * zc[..., 1] + w2 * zc[..., 2]
        ok = inside & (z >= lo) & (z <= hi) & (idc[:, None, :] >= 0)
        count += ok.sum(dim=-1, dtype=torch.int32)
        if k == 0:
            continue
        z = torch.where(ok, z, torch.full_like(z, _NEG))
        ids = torch.where(ok, idc[:, None, :].expand_as(ok),
                          torch.full_like(idc[:, None, :], -1))
        all_z = torch.cat([best_z, z], dim=-1)
        all_i = torch.cat([best_i, ids], dim=-1)
        # stable: equal z keep their order (earlier list entries first)
        top, pos = torch.sort(all_z, dim=-1, descending=True, stable=True)
        best_z = top[..., :k].contiguous()
        best_i = torch.gather(all_i, -1, pos[..., :k])
    return best_z, best_i, count


def _csr_to_padded(cand_n, offsets_t1):
    """CSR lists -> (T, longest) int32, -1 padded."""
    lengths = offsets_t1[1:] - offsets_t1[:-1]
    t = lengths.shape[0]
    width = int(lengths.max()) if t else 0
    out = torch.full((t, width), -1, dtype=torch.int32, device=cand_n.device)
    row = torch.repeat_interleave(torch.arange(t, device=cand_n.device),
                                  lengths)
    first = offsets_t1[0]
    col = torch.arange(row.shape[0], device=cand_n.device) + first \
        - offsets_t1[row]
    out[row, col] = cand_n[first:first + row.shape[0]]
    return out


def raster_hit_plain(pix_px2, range_px2, face_z_fx3, face_img_fx3x2,
                     cand_n, offsets_t1, tile_pixels: int, k: int,
                     chunk: int = 1024):
    """Plain PyTorch version of the hit pass (see ``raster_hit``): the
    candidate lists are scanned in chunks of ``chunk``, each merged into
    the running k best by a stable sort; tiles are taken a few at a time
    (or a tile's pixels a block at a time) to bound the merge buffer."""
    p = pix_px2.shape[0]
    t = offsets_t1.shape[0] - 1
    dev = pix_px2.device
    ids = torch.full((p, k), -1, dtype=torch.int32, device=dev)
    zs = torch.full((p, k), _NEG, dtype=torch.float32, device=dev)
    counts = torch.zeros((p,), dtype=torch.int32, device=dev)
    if p == 0:
        return ids, zs, counts
    cand = _csr_to_padded(cand_n, offsets_t1.long())
    padded = _edge_pad_rows(torch.cat([pix_px2, range_px2], dim=1),
                            tile_pixels).reshape(t, tile_pixels, 4)
    rows = max(1, _PLAIN_ELEMS // (k + chunk))
    if tile_pixels <= rows:
        step = max(1, rows // tile_pixels)
        pieces = [(slice(t0, t0 + step), slice(None))
                  for t0 in range(0, t, step)]
    else:
        pieces = [(slice(t0, t0 + 1), slice(r0, r0 + rows))
                  for t0 in range(t) for r0 in range(0, tile_pixels, rows)]
    for ts, rs in pieces:
        part = padded[ts, rs]
        z, i, c = _scan_tiles(part[..., :2], part[..., 2:], face_z_fx3,
                              face_img_fx3x2, cand[ts], chunk, k)
        first = ts.start * tile_pixels
        lin = (torch.arange(part.shape[0], device=dev)[:, None] * tile_pixels
               + torch.arange(tile_pixels, device=dev)[rs][None, :]
               + first).reshape(-1)
        keep = lin < p
        lin = lin[keep]
        counts[lin] = c.reshape(-1)[keep]
        if k:
            ids[lin] = i.reshape(-1, k)[keep]
            zs[lin] = z.reshape(-1, k)[keep]
    return ids, zs, counts


def _raster_hit_cuda(pix, ranges, face_z, face_img, cand, offsets,
                     tile_pixels, k):
    for name, x in (("pixels", pix), ("ranges", ranges), ("face z", face_z),
                    ("face xy", face_img), ("candidates", cand),
                    ("offsets", offsets)):
        if not x.is_contiguous():
            raise ValueError(f"raster_hit kernel needs contiguous {name}")
    p = pix.shape[0]
    t = offsets.shape[0] - 1
    ids = torch.empty((p, k), dtype=torch.int32, device=pix.device)
    zs = torch.empty((p, k), dtype=torch.float32, device=pix.device)
    counts = torch.empty((p,), dtype=torch.int32, device=pix.device)
    lib = _cuda.library(_KERNEL)
    with torch.cuda.device(pix.device):
        err = lib.deftet_raster_hit(
            pix.data_ptr(), ranges.data_ptr(), face_z.data_ptr(),
            face_img.data_ptr(), cand.data_ptr(), offsets.data_ptr(),
            ids.data_ptr(), zs.data_ptr(), counts.data_ptr(), p, t,
            tile_pixels, k, _cuda.stream_handle(pix.device),
        )
    _cuda.check(lib, err, _KERNEL)
    _cuda.count_launch(_KERNEL)
    return ids, zs, counts


def raster_hit(pix_px2, range_px2, face_z_fx3, face_img_fx3x2, cand_n,
               offsets_t1, tile_pixels: int, k: int, chunk: int = 1024):
    """Hit pass over consecutive tiles of ``tile_pixels`` pixels (the last
    may be short); tile t scans ``cand_n[offsets_t1[t]:offsets_t1[t+1]]``
    (int32 face ids, -1 skipped; offsets int64).  Returns (ids (P, k)
    int32, z (P, k) float32, counts (P,) int32): the k nearest covering
    faces, z descending and list order on ties, -1 / -1e10 past the
    hits, and the exact number of covering faces.  ``chunk`` is the plain
    version's candidate chunk (it changes nothing in the result)."""
    pix = pix_px2.detach().float().contiguous()
    ranges = range_px2.detach().float().contiguous()
    face_z = face_z_fx3.detach().float().contiguous()
    face_img = face_img_fx3x2.detach().float().contiguous()
    cand = cand_n.to(torch.int32).contiguous()
    offsets = offsets_t1.to(torch.int64).contiguous()
    t = offsets.shape[0] - 1
    if pix.shape[0] and t != -(-pix.shape[0] // tile_pixels):
        raise ValueError("one candidate list per tile of tile_pixels pixels")
    devices = {x.device for x in (pix, ranges, face_z, face_img, cand,
                                  offsets)}
    if len(devices) != 1:
        raise ValueError("raster_hit inputs must be on one device")
    if pix.device.type == "cuda":
        return _raster_hit_cuda(pix, ranges, face_z, face_img, cand,
                                offsets, int(tile_pixels), int(k))
    if pix.device.type == "cpu":
        return raster_hit_plain(pix, ranges, face_z, face_img, cand,
                                offsets, int(tile_pixels), int(k), chunk)
    raise RuntimeError(f"no hit-pass implementation for {pix.device}")


def _one_list(face_id_f, pix_px2):
    """The unbinned layout: one tile holding every pixel, one list."""
    f = face_id_f.shape[0]
    offsets = torch.tensor([0, f], dtype=torch.int64, device=face_id_f.device)
    return face_id_f, offsets, max(int(pix_px2.shape[0]), 1)


def _hit_topk_ids_counted(pix_px2, range_px2, face_z_fx3, face_img_fx3x2,
                          face_id_f, chunk: int, k: int):
    """The hit pass in the JAX helpers' form, over explicit face rows
    labelled ``face_id_f`` (-1 = dead row), scanned in order: (z (P, k),
    labels (P, k), exact hit count (P,))."""
    rows = torch.arange(face_id_f.shape[0], dtype=torch.int32,
                        device=face_id_f.device)
    rows = torch.where(face_id_f >= 0, rows, torch.full_like(rows, -1))
    cand, offsets, tile = _one_list(rows, pix_px2)
    idx, z, counts = raster_hit(pix_px2, range_px2, face_z_fx3,
                                face_img_fx3x2, cand, offsets, tile, k,
                                chunk)
    labels = face_id_f.to(torch.int32)[idx.clamp_min(0).long()]
    return z, torch.where(idx >= 0, labels, idx), counts


def hit_count_max(pixrange_px4, face_z_fx3, face_img_fx3x2,
                  chunk: int = 2048) -> int:
    """Max per-pixel covering-face count over every face: any peel depth
    at or above it renders these pixels exactly."""
    face_id = torch.arange(face_z_fx3.shape[0], dtype=torch.int32,
                           device=face_z_fx3.device)
    counts = _hit_topk_ids_counted(pixrange_px4[..., :2],
                                   pixrange_px4[..., 2:], face_z_fx3,
                                   face_img_fx3x2, face_id, chunk, 0)[2]
    return int(counts.max()) if counts.numel() else 0


# --------------------------------------------------------------- binning
def _tile_candidates(tile_lo_tx2, tile_hi_tx2, fmin_fx2, fmax_fx2,
                     n_cand: int):
    """Face ids whose screen bbox overlaps each tile's [lo, hi]: (cand
    (T, n_cand) int32 ascending, -1 padded, the first ``n_cand`` kept;
    overflow (T,) = how many overlapping faces did not fit)."""
    ok = ((fmin_fx2[None, :, 0] <= tile_hi_tx2[:, None, 0])
          & (fmax_fx2[None, :, 0] >= tile_lo_tx2[:, None, 0])
          & (fmin_fx2[None, :, 1] <= tile_hi_tx2[:, None, 1])
          & (fmax_fx2[None, :, 1] >= tile_lo_tx2[:, None, 1]))
    t, f = ok.shape
    pos = torch.cumsum(ok.to(torch.int32), dim=1) - 1
    dest = torch.where(ok & (pos < n_cand), pos,
                       torch.full_like(pos, n_cand)).long()
    cand = torch.full((t, n_cand + 1), -1, dtype=torch.int32,
                      device=ok.device)
    ids = torch.arange(f, dtype=torch.int32, device=ok.device)
    cand.scatter_(1, dest, ids[None].expand(t, f))
    overflow = (pos[:, -1] + 1 - n_cand).clamp_min(0) if f else \
        torch.zeros(t, dtype=torch.int32, device=ok.device)
    return cand[:, :n_cand].contiguous(), overflow


def _edge_pad_rows(x, multiple: int):
    """Pad axis 0 to a multiple by repeating the last row, so the last
    tile's bbox stays tight."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])], dim=0)


def _raster_order(pix_px2):
    """np.lexsort((x, y)) in torch: by y, then x, stable."""
    by_x = torch.argsort(pix_px2[:, 0], stable=True)
    return by_x[torch.argsort(pix_px2[by_x, 1], stable=True)]


def bin_overlap_max_np(face_img_fx3x2, pix_px2, pixel_chunk: int,
                       sort: bool = True) -> int:
    """Host-side (numpy) max per-tile bbox-overlap count: any ``bin_cand``
    at or above it makes the binned render of these pixels exact.
    ``sort`` mirrors the render's ``bin_sort``."""
    pix = np.asarray(pix_px2, dtype=np.float32)
    if sort:
        pix = pix[np.lexsort((pix[:, 0], pix[:, 1]))]
    n = pix.shape[0]
    target = -(-n // pixel_chunk) * pixel_chunk
    if target != n:
        pix = np.concatenate([pix, np.tile(pix[-1:], (target - n, 1))])
    tiles = pix.reshape(-1, pixel_chunk, 2)
    lo, hi = tiles.min(axis=1), tiles.max(axis=1)
    face_img = np.asarray(face_img_fx3x2)
    fmin, fmax = face_img.min(axis=1), face_img.max(axis=1)
    worst = 0
    for t in range(lo.shape[0]):
        ok = ((fmin[:, 0] <= hi[t, 0]) & (fmax[:, 0] >= lo[t, 0])
              & (fmin[:, 1] <= hi[t, 1]) & (fmax[:, 1] >= lo[t, 1]))
        worst = max(worst, int(ok.sum()))
    return worst


def bin_overflow(face_img_fx3x2, pix_px2, pixel_chunk: int,
                 n_cand: int) -> int:
    """Max per-tile candidate overflow of the raster-order binning of these
    pixels (0 = the binned render is exact)."""
    pix = _edge_pad_rows(pix_px2[_raster_order(pix_px2)], pixel_chunk)
    tiles = pix.reshape(-1, pixel_chunk, 2)
    _, over = _tile_candidates(tiles.amin(dim=1), tiles.amax(dim=1),
                               face_img_fx3x2.amin(dim=1),
                               face_img_fx3x2.amax(dim=1), n_cand)
    return int(over.max())


# ------------------------------------------------------------ the render
def _select(pix, ranges, face_z, face_img, k, chunk, pixel_chunk, bin_cand,
            bin_sort):
    """(P, k) hit ids of one batch element, binned or not."""
    p = pix.shape[0]
    if not bin_cand:
        cand = torch.arange(face_z.shape[0], dtype=torch.int32,
                            device=pix.device)
        cand, offsets, tile = _one_list(cand, pix)
        return raster_hit(pix, ranges, face_z, face_img, cand, offsets, tile,
                          k, chunk)[0]
    if bin_sort:
        order = _raster_order(pix)
        pix, ranges = pix[order], ranges[order]
    tiles = _edge_pad_rows(pix, pixel_chunk).reshape(-1, pixel_chunk, 2)
    cand, _ = _tile_candidates(tiles.amin(dim=1), tiles.amax(dim=1),
                               face_img.amin(dim=1), face_img.amax(dim=1),
                               bin_cand)
    offsets = torch.arange(cand.shape[0] + 1, device=pix.device) * bin_cand
    idx = raster_hit(pix, ranges, face_z, face_img, cand.reshape(-1),
                     offsets, pixel_chunk, k, chunk)[0]
    if bin_sort:
        idx = torch.empty_like(idx).index_copy_(0, order, idx)
    return idx


def deftet_sparse_render(
    pixel_coords_1xpx2: torch.Tensor,
    render_ranges_1xpx2: torch.Tensor,
    face_vertices_z_bxfx3: torch.Tensor,
    face_vertices_image_bxfx3x2: torch.Tensor,
    face_features_bxfx3xc: torch.Tensor,
    k: int = 30,
    chunk: int = 1024,
    pixel_chunk: int = 8192,
    bin_cand: int = 0,
    bin_sort: bool = True,
):
    """Render k depth-peeled feature layers per pixel.

    Returns (features (B, P, k, C), face ids (B, P, k) int32, -1 where no
    face).  Differentiable w.r.t. face z, image positions and features
    through the replay on the chosen faces.  ``bin_cand`` > 0 enables
    screen-space binning (see the module docstring); ``bin_sort=False``
    keeps the caller's pixel order, each ``pixel_chunk`` run one tile.
    """
    pix = pixel_coords_1xpx2[0].float()
    ranges = render_ranges_1xpx2[0].float()
    b, n_faces = face_vertices_z_bxfx3.shape[:2]
    p = pix.shape[0]
    if bin_cand >= n_faces:
        bin_cand = 0  # culling cannot help
    pixel_chunk = min(pixel_chunk, -(-p // 512) * 512)
    with torch.no_grad():
        idx = torch.stack([
            _select(pix.detach(), ranges.detach(),
                    face_vertices_z_bxfx3[i].detach(),
                    face_vertices_image_bxfx3x2[i].detach(), k, chunk,
                    pixel_chunk, bin_cand, bin_sort)
            for i in range(b)
        ])  # (B, P, k)

    # ---- differentiable replay on the chosen faces, hit slots only: a
    # dense gather would point every empty slot at one face, and the
    # backward's scatter-add then serializes on that one index
    bi, pi, si = torch.nonzero(idx >= 0, as_tuple=True)
    fid = idx[bi, pi, si].long()
    tri_img = face_vertices_image_bxfx3x2[bi, fid]       # (N, 3, 2)
    tri_feat = face_features_bxfx3xc[bi, fid]            # (N, 3, C)
    w0, w1, w2 = barycentric_2d(pix[pi], tri_img)
    vals = (w0[:, None] * tri_feat[:, 0] + w1[:, None] * tri_feat[:, 1]
            + w2[:, None] * tri_feat[:, 2])
    feat = vals.new_zeros(idx.shape + vals.shape[-1:]).index_put(
        (bi, pi, si), vals)
    return feat, idx
