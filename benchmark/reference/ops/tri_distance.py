"""K3: point-to-triangle-soup argmin, and the differentiable
point-to-mesh squared distance built on it.

``tri_argmin`` replaces deftet_tpu/ops/tri_distance_pallas.py:_tri_kernel
(reached via tri_argmin_pallas_single / tri_argmin_pallas).  Semantics,
kept in both versions: the region-based closest point in the Pallas
kernel's region order, ``safe_div`` with eps 1e-20, masked faces never
chosen, ties to the lowest index, index 0 when every face is masked, and
no face at or past ``n_active`` (1 + the last unmasked index) scanned.

In this frozen copy every device runs
``tri_argmin_plain``.  ``point_to_mesh_squared_distance`` recomputes the
distance on the chosen face with autograd, as
deftet_tpu/ops/tri_distance.py:126-176 does.
"""

from __future__ import annotations

import torch

from ..remat import saved

_KERNEL = "tri_argmin"
_BIG = 1.0e30
_EPS = 1e-20


def _safe_div(x, y):
    return x / torch.where(y.abs() < _EPS, torch.ones_like(y), y)


def _tri_d2(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """Squared point-triangle distance on broadcastable components, in the
    Pallas kernel's operation order (differentiable, branch-free)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    v_ab = _safe_div(d1, d1 - d3)
    w_ac = _safe_div(d2, d2 - d6)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = va + vb + vc
    v_in = _safe_div(vb, denom)
    w_in = _safe_div(vc, denom)

    qx = ax + v_in * abx + w_in * acx
    qy = ay + v_in * aby + w_in * acy
    qz = az + v_in * abz + w_in * acz
    regions = (
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         (bx + w_bc * (cx - bx), by + w_bc * (cy - by),
          bz + w_bc * (cz - bz))),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0),
         (ax + w_ac * acx, ay + w_ac * acy, az + w_ac * acz)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0),
         (ax + v_ab * abx, ay + v_ab * aby, az + v_ab * abz)),
        ((d6 >= 0) & (d5 <= d6), (cx, cy, cz)),
        ((d3 >= 0) & (d4 <= d3), (bx, by, bz)),
        ((d1 <= 0) & (d2 <= 0), (ax, ay, az)),
    )
    for sel, (rx, ry, rz) in regions:  # the last region applied wins
        qx = torch.where(sel, rx, qx)
        qy = torch.where(sel, ry, qy)
        qz = torch.where(sel, rz, qz)
    dx, dy, dz = px - qx, py - qy, pz - qz
    return dx * dx + dy * dy + dz * dz


def point_triangle_squared_distance(p, a, b, c):
    """Closed-form squared distance point -> triangle; inputs (..., 3)."""
    return _tri_d2(*p.unbind(-1), *a.unbind(-1), *b.unbind(-1),
                   *c.unbind(-1))


def active_face_count(face_mask_bxf: torch.Tensor) -> torch.Tensor:
    """(B,) int32: 1 + index of the last unmasked face, 0 if none."""
    b, f = face_mask_bxf.shape
    if f == 0:
        return torch.zeros(b, dtype=torch.int32, device=face_mask_bxf.device)
    pos = torch.arange(1, f + 1, device=face_mask_bxf.device)
    last = torch.where(face_mask_bxf > 0, pos, torch.zeros_like(pos))
    return last.amax(dim=1).to(torch.int32)


def tri_argmin_plain(points, tri, face_mask, n_active, chunk: int = 1024):
    """Plain PyTorch version, chunked over points so the (P, F) distance
    matrix is never whole.  Returns (B, P) int32."""
    b, p, _ = points.shape
    out = torch.zeros((b, p), dtype=torch.int32, device=points.device)
    for bi in range(b):
        na = int(n_active[bi])
        if na <= 0:
            continue
        t = tri[bi, :na].reshape(na, 9)
        corners = [t[None, :, k] for k in range(9)]
        valid = face_mask[bi, None, :na] > 0
        for s in range(0, p, chunk):
            pp = points[bi, s:s + chunk]
            d = _tri_d2(pp[:, 0:1], pp[:, 1:2], pp[:, 2:3], *corners)
            d = torch.where(valid, d, torch.full_like(d, _BIG))
            dmin, imin = torch.min(d, dim=1)
            out[bi, s:s + chunk] = torch.where(
                dmin < _BIG, imin, torch.zeros_like(imin)).to(torch.int32)
    return out


def _check(points, tri, face_mask):
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError("points must be (B, P, 3)")
    if tri.dim() != 4 or tri.shape[-2:] != (3, 3):
        raise ValueError("triangles must be (B, F, 3, 3)")
    if face_mask.shape != tri.shape[:2] or points.shape[0] != tri.shape[0]:
        raise ValueError("mask must be (B, F) matching the triangles")
    for t in (points, tri, face_mask):
        if t.dtype != torch.float32:
            raise TypeError("tri_argmin takes float32 inputs")
        if t.device != points.device:
            raise ValueError("all inputs must be on one device")


def tri_argmin(points_bxpx3, tri_bxfx3x3, face_mask_bxf):
    """(B, P) int32 index of the nearest unmasked triangle per point."""
    pts = points_bxpx3.detach()
    tri = tri_bxfx3x3.detach()
    mask = face_mask_bxf.detach()
    _check(pts, tri, mask)
    n_active = active_face_count(mask)
    return tri_argmin_plain(pts, tri, mask, n_active)


def point_to_mesh_squared_distance(points_bxpx3, tri_bxfx3x3,
                                   face_mask_bxf=None):
    """(squared distance (B, P), argmin face (B, P) int32) to the nearest
    unmasked triangle; differentiable w.r.t. points and triangles through
    the recompute on the chosen face.  0 where every face is masked.  The
    index is kept for a rematerialized backward (``remat.saved``)."""
    pts = points_bxpx3.float()
    tri = tri_bxfx3x3.float()
    if face_mask_bxf is None:
        face_mask_bxf = torch.ones(tri.shape[:2], dtype=torch.float32,
                                   device=tri.device)
    idx = saved("tri_argmin_idx", lambda: tri_argmin(
        pts.contiguous(), tri.contiguous(),
        face_mask_bxf.float().contiguous()))
    best = torch.gather(
        tri, 1, idx.long()[:, :, None, None].expand(-1, -1, 3, 3)
    )
    d2 = point_triangle_squared_distance(
        pts, best[..., 0, :], best[..., 1, :], best[..., 2, :]
    )
    any_valid = torch.sum(face_mask_bxf, dim=1, keepdim=True) > 0
    return torch.where(any_valid, d2, torch.zeros_like(d2)), idx
