"""Watertight point-in-mesh test by +z ray-crossing parity (torch port of
deftet_tpu/ops/check_sign.py).

A point is inside iff a ray to +z crosses the surface an odd number of
times.  Each (point, face) crossing is a 2D barycentric solve in the xy
plane; queries are jittered by a fixed ~1e-7 so that rays miss edges and
vertices.  The JAX package runs this scan in XLA, not in a Pallas kernel,
so the port keeps it a plain PyTorch scan, chunked over queries and faces.
Float32, no gradient.
"""

from __future__ import annotations

import torch

_JITTER = (4.9e-7, 7.3e-7, 0.0)


@torch.no_grad()
def check_sign(verts_bxnx3: torch.Tensor, faces_bxfx3: torch.Tensor,
               query_bxpx3: torch.Tensor, n_valid_faces=None,
               chunk: int = 1024, query_chunk: int = 4096) -> torch.Tensor:
    """(B, P) float occupancy, 1 inside and 0 outside.  Faces at or past
    ``n_valid_faces[b]`` (padding) are ignored."""
    v = verts_bxnx3.detach().float()
    f = faces_bxfx3.long()
    q = query_bxpx3.detach().float() + torch.tensor(
        _JITTER, dtype=torch.float32, device=query_bxpx3.device)
    b, n_faces = f.shape[0], f.shape[1]
    if n_valid_faces is None:
        n_valid_faces = torch.full((b,), n_faces, device=q.device)
    n_valid_faces = n_valid_faces.to(q.device)
    tri = v[torch.arange(b, device=v.device)[:, None, None], f]  # (B,F,3,3)
    v0 = tri[:, :, 0]
    e1 = tri[:, :, 1] - v0
    e2 = tri[:, :, 2] - v0
    denom = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    safe = (denom.abs() > 1e-12) & (
        torch.arange(n_faces, device=q.device)[None] < n_valid_faces[:, None])
    denom = torch.where(safe, denom, torch.ones_like(denom))
    count = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    for qs in range(0, q.shape[1], query_chunk):
        qq = q[:, qs:qs + query_chunk, None, :]  # (B, Pc, 1, 3)
        for fs in range(0, n_faces, chunk):
            sl = slice(fs, fs + chunk)
            o, a, c = v0[:, None, sl], e1[:, None, sl], e2[:, None, sl]
            dn = denom[:, None, sl]
            sx = qq[..., 0] - o[..., 0]
            sy = qq[..., 1] - o[..., 1]
            u = (sx * c[..., 1] - sy * c[..., 0]) / dn
            w = (a[..., 0] * sy - a[..., 1] * sx) / dn
            inside = (u >= 0.0) & (w >= 0.0) & (u + w <= 1.0)
            z_hit = o[..., 2] + u * a[..., 2] + w * c[..., 2]
            cross = inside & (z_hit > qq[..., 2]) & safe[:, None, sl]
            count[:, qs:qs + query_chunk] += cross.sum(dim=2,
                                                       dtype=torch.int32)
    return (count % 2).to(torch.float32)
