"""Point-in-tetrahedron query: the first (lowest-index) tet containing each
point, or -1 (torch port of deftet_tpu/ops/point_tet.py).

Four same-side tests per (point, tet): the plane through three corners,
with the query and the fourth corner on one side.  The JAX package runs
this scan in XLA, not in a Pallas kernel, so the port keeps it a plain
PyTorch scan, chunked over queries and tets so that no (P, T) array is
whole.  The expressions keep the JAX package's order, so indices agree.
No gradient.
"""

from __future__ import annotations

import torch

_BIG = 2**30


def _planes(soa):
    """Per-tet planes of the four same-side tests: 4 tuples of
    (nx, ny, nz, off, ref), each (B, T) float32."""
    corners = [tuple(soa[k][c].detach().float() for c in range(3))
               for k in range(4)]
    a, b, c, d = corners
    planes = []
    for p1, p2, p3, p4 in ((a, b, c, d), (a, b, d, c), (a, c, d, b),
                           (b, c, d, a)):
        (x1, y1, z1), (x2, y2, z2), (x3, y3, z3), (x4, y4, z4) = (
            p1, p2, p3, p4)
        e1x, e1y, e1z = x2 - x1, y2 - y1, z2 - z1
        e2x, e2y, e2z = x3 - x1, y3 - y1, z3 - z1
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        ref = (x4 - x1) * nx + (y4 - y1) * ny + (z4 - z1) * nz
        off = x1 * nx + y1 * ny + z1 * nz
        planes.append((nx, ny, nz, off, ref))
    return planes


@torch.no_grad()
def points_in_tets_soa(soa, query_bxpx3: torch.Tensor, chunk: int = 4096,
                       query_chunk: int = 4096) -> torch.Tensor:
    """(B, P) int32 first containing tet per point, or -1.  ``soa`` is the
    corner structure of ``losses.geometry.gather_tet_soa``:
    soa[k][c] = (B, T)."""
    q = query_bxpx3.detach().float()
    b, p, _ = q.shape
    planes = _planes(soa)
    t = planes[0][0].shape[1]
    found = torch.full((b, p), _BIG, dtype=torch.int64, device=q.device)
    for bi in range(b):
        for qs in range(0, p, query_chunk):
            qx, qy, qz = (q[bi, qs:qs + query_chunk, c, None]
                          for c in range(3))
            best = found[bi, qs:qs + query_chunk]
            for ts in range(0, t, chunk):
                inside = None
                for nx, ny, nz, off, ref in planes:
                    sl = slice(ts, ts + chunk)
                    qd = (qx * nx[bi, None, sl] + qy * ny[bi, None, sl]
                          + qz * nz[bi, None, sl] - off[bi, None, sl])
                    ok = qd * ref[bi, None, sl] >= 0.0
                    inside = ok if inside is None else inside & ok
                hit = inside.any(dim=1)
                first = ts + inside.to(torch.uint8).argmax(dim=1)
                cand = torch.where(hit, first, torch.full_like(first, _BIG))
                torch.minimum(best, cand, out=best)
    return torch.where(found == _BIG, torch.full_like(found, -1),
                       found).to(torch.int32)


def points_in_tets(tet_pos_bxtx4x3: torch.Tensor, query_bxpx3: torch.Tensor,
                   chunk: int = 4096, query_chunk: int = 4096) -> torch.Tensor:
    """``points_in_tets_soa`` on the corner tensor (B, T, 4, 3), detached
    and in float32 (prefer the SoA form, which needs no corner tensor)."""
    t = tet_pos_bxtx4x3.detach().float()
    soa = [[t[:, :, k, c] for c in range(3)] for k in range(4)]
    return points_in_tets_soa(soa, query_bxpx3, chunk, query_chunk)


def paste_occupancy(tet_occ_bxt: torch.Tensor,
                    condition_bxp: torch.Tensor) -> torch.Tensor:
    """Per-tet occupancy at each point's containing tet; a point outside
    every tet (-1) reads tet 0."""
    cond = torch.clamp(condition_bxp, min=0).long()
    return torch.gather(tet_occ_bxt, 1, cond)
