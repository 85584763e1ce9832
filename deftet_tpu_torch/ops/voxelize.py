"""Point <-> voxel transfer for the PVCNN encoder and the occupancy
texture read (torch port of deftet_tpu/ops/voxelize.py).

Channels-last layouts as in the JAX package: points (B, N, C), voxels
(B, R, R, R, C) with axis order (x, y, z).
"""

from __future__ import annotations

import torch

from ..data.pipeline import OCC_GRID_EXTENT


def avg_voxelize(features_bxnxc: torch.Tensor, coords_bxnx3: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """Scatter-mean of point features into an R^3 grid (empty voxels are
    zero); coords are integer voxel coordinates in [0, R-1]."""
    b, n, c = features_bxnxc.shape
    r = resolution
    coords = coords_bxnx3.long().clamp(0, r - 1)
    flat = coords[..., 0] * (r * r) + coords[..., 1] * r + coords[..., 2]
    offset = torch.arange(b, device=flat.device)[:, None] * (r * r * r)
    idx = (flat + offset).reshape(-1)
    sums = torch.zeros((b * r**3, c), dtype=features_bxnxc.dtype,
                       device=features_bxnxc.device).index_add(
        0, idx, features_bxnxc.reshape(b * n, c))
    counts = torch.zeros((b * r**3,), dtype=torch.float32,
                         device=features_bxnxc.device).index_add(
        0, idx, torch.ones((b * n,), dtype=torch.float32,
                           device=features_bxnxc.device))
    out = sums / counts.clamp(min=1.0)[:, None].to(features_bxnxc.dtype)
    return out.reshape(b, r, r, r, c)


def trilinear_devoxelize(voxels_bxrc: torch.Tensor,
                         coords_bxnx3: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation at continuous voxel-center coordinates with
    border clamping; differentiable w.r.t. voxels and coordinates."""
    b, r = voxels_bxrc.shape[0], voxels_bxrc.shape[1]
    c_dim = voxels_bxrc.shape[-1]
    coords = coords_bxnx3.clamp(0.0, r - 1.0)
    i0f = torch.floor(coords)
    frac = coords - i0f
    i0 = i0f.long()
    i1 = (i0 + 1).clamp(max=r - 1)
    vox_flat = voxels_bxrc.reshape(b, r**3, c_dim)
    out = 0.0
    for sx in (False, True):
        for sy in (False, True):
            for sz in (False, True):
                ix = i1[..., 0] if sx else i0[..., 0]
                iy = i1[..., 1] if sy else i0[..., 1]
                iz = i1[..., 2] if sz else i0[..., 2]
                flat = ix * (r * r) + iy * r + iz
                vals = torch.gather(
                    vox_flat, 1, flat[..., None].expand(-1, -1, c_dim))
                wx = frac[..., 0] if sx else 1.0 - frac[..., 0]
                wy = frac[..., 1] if sy else 1.0 - frac[..., 1]
                wz = frac[..., 2] if sz else 1.0 - frac[..., 2]
                out = out + vals * (wx * wy * wz)[..., None]
    return out


def _trilinear_scalar_soa(grid_bxgxgxg, cx, cy, cz):
    """Trilinear sample of a scalar grid at SoA coords (each (B, P))."""
    b, g = grid_bxgxgxg.shape[0], grid_bxgxgxg.shape[1]
    flat = grid_bxgxgxg.reshape(b, g**3)
    comps = []
    for c in (cx, cy, cz):
        c = c.clamp(0.0, g - 1.0)
        i0 = torch.floor(c)
        comps.append((i0.long(), c - i0))
    out = 0.0
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                ix = (comps[0][0] + sx).clamp(max=g - 1)
                iy = (comps[1][0] + sy).clamp(max=g - 1)
                iz = (comps[2][0] + sz).clamp(max=g - 1)
                w = ((comps[0][1] if sx else 1.0 - comps[0][1])
                     * (comps[1][1] if sy else 1.0 - comps[1][1])
                     * (comps[2][1] if sz else 1.0 - comps[2][1]))
                vals = torch.gather(flat, 1, ix * (g * g) + iy * g + iz)
                out = out + vals * w
    return out


def occupancy_from_grid(occ_grid_bxgxgxg: torch.Tensor,
                        points_bxpx3: torch.Tensor,
                        threshold: float = 0.5) -> torch.Tensor:
    """``occupancy_from_grid_soa`` at (B, P, 3) points, "nearest"."""
    pts = points_bxpx3.detach()
    return occupancy_from_grid_soa(occ_grid_bxgxgxg, pts[..., 0],
                                   pts[..., 1], pts[..., 2],
                                   threshold=threshold)


@torch.no_grad()
def occupancy_from_grid_soa(occ_grid_bxgxgxg, x_bxp, y_bxp, z_bxp,
                            threshold: float = 0.5,
                            interp: str = "nearest") -> torch.Tensor:
    """{0, 1} float labels (B, P) read from the [-E, E]^3 cell-centered
    occupancy texture at SoA coordinates; "nearest" reads one voxel of the
    pre-thresholded grid, "trilinear" thresholds the 8-corner blend."""
    g = occ_grid_bxgxgxg.shape[1]

    def to_vox(c):
        return (c + OCC_GRID_EXTENT) / (2 * OCC_GRID_EXTENT) * g - 0.5

    cx, cy, cz = to_vox(x_bxp), to_vox(y_bxp), to_vox(z_bxp)
    if interp == "nearest":
        bits = (occ_grid_bxgxgxg > threshold).to(torch.int8)
        flat = bits.reshape(bits.shape[0], g**3)
        ix, iy, iz = (torch.round(c).clamp(0, g - 1).long()
                      for c in (cx, cy, cz))
        vals = torch.gather(flat, 1, ix * (g * g) + iy * g + iz)
        return vals.to(torch.float32)
    if interp != "trilinear":
        raise ValueError(f"unknown occupancy interpolation {interp!r}")
    vals = _trilinear_scalar_soa(occ_grid_bxgxgxg.float(), cx, cy, cz)
    return (vals > threshold).to(torch.float32)
