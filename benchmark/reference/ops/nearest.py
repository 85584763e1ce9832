"""K2: brute-force nearest neighbour, and the differentiable one-sided
squared distance built on it.

``nearest_neighbor`` replaces deftet_tpu/ops/nearest_pallas.py:_nn_kernel
(reached via nn_pallas_single / _nn_single_scan_refs /
nearest_neighbor_pallas).  Semantics, kept in both versions:

* distance by direct difference ``sum((r - q)^2)``, summed x, y, z in
  order; ties go to the lowest index; the distance is clamped >= 0;
* only the first ``n_valid[b]`` references count (no valid reference:
  distance 1e30, index 0);
* queries in 512-query tiles lying wholly past ``n_queries[b]`` return
  (0, 0) and are not scanned;
* no cap on the reference count (the Pallas 16,384 cap was a VMEM limit).

In this frozen copy every device runs ``nearest_neighbor_plain``.  The index is
not differentiable; ``sided_squared_distance`` recomputes the distance
through a gather, as deftet_tpu/ops/nearest.py:122-143 does.
"""

from __future__ import annotations


import torch

from ..remat import saved

_KERNEL = "nearest"
QUERY_TILE = 512  # the skip rule's granularity (nearest_pallas tile_p)
_BIG = 1.0e30


def _defaults(q, r, n_valid, n_queries):
    b, p, m = q.shape[0], q.shape[1], r.shape[1]
    if n_valid is None:
        n_valid = torch.full((b,), m, dtype=torch.int32, device=q.device)
    if n_queries is None:
        n_queries = torch.full((b,), p, dtype=torch.int32, device=q.device)
    return n_valid.to(torch.int32), n_queries.to(torch.int32)


def _check(q, r, n_valid, n_queries):
    if q.dim() != 3 or q.shape[-1] != 3 or r.dim() != 3 or r.shape[-1] != 3:
        raise ValueError("queries and points must be (B, N, 3)")
    if q.shape[0] != r.shape[0]:
        raise ValueError("queries and points must share the batch size")
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError("nearest_neighbor takes float32 clouds")
    for t in (r, n_valid, n_queries):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    if n_valid.shape != (q.shape[0],) or n_queries.shape != (q.shape[0],):
        raise ValueError("n_valid and n_queries must be (B,)")


def _skip_mask(p: int, n_queries: torch.Tensor) -> torch.Tensor:
    """(B, P) True where a query's 512-tile lies wholly past n_queries."""
    tile_start = (torch.arange(p, device=n_queries.device) // QUERY_TILE
                  ) * QUERY_TILE
    return tile_start[None, :] >= n_queries[:, None]


def nearest_neighbor_plain(q, r, n_valid, n_queries, chunk: int = 4096):
    """Plain PyTorch version, chunked over queries so the (P, M) distance
    matrix is never whole.  Returns (d2 (B, P) f32, idx (B, P) int32)."""
    b, p, _ = q.shape
    m = r.shape[1]
    d_out = torch.zeros((b, p), dtype=torch.float32, device=q.device)
    i_out = torch.zeros((b, p), dtype=torch.int32, device=q.device)
    nv = n_valid.clamp(0, m)
    live = min(p, -(-int(n_queries.max().clamp(min=0)) // QUERY_TILE)
               * QUERY_TILE) if p else 0
    ids = torch.arange(m, device=q.device)
    for bi in range(b):
        valid = ids[None, :] < nv[bi]
        rx, ry, rz = (r[bi, None, :, k] for k in range(3))
        for s in range(0, live, chunk):
            qq = q[bi, s:s + chunk]
            dx = rx - qq[:, 0:1]
            dy = ry - qq[:, 1:2]
            dz = rz - qq[:, 2:3]
            d = dx * dx + dy * dy + dz * dz
            d = torch.where(valid, d, torch.full_like(d, _BIG))
            if m:
                dmin, imin = torch.min(d, dim=1)
            else:
                dmin = torch.full((qq.shape[0],), _BIG, device=q.device)
                imin = torch.zeros((qq.shape[0],), dtype=torch.int64,
                                   device=q.device)
            take = dmin < _BIG
            d_out[bi, s:s + chunk] = torch.where(
                take, dmin, torch.full_like(dmin, _BIG)).clamp(min=0.0)
            i_out[bi, s:s + chunk] = torch.where(
                take, imin, torch.zeros_like(imin)).to(torch.int32)
    skip = _skip_mask(p, n_queries)
    d_out = torch.where(skip, torch.zeros_like(d_out), d_out)
    i_out = torch.where(skip, torch.zeros_like(i_out), i_out)
    return d_out, i_out


def nearest_neighbor(query_bxpx3, points_bxmx3, n_valid=None,
                     n_queries=None):
    """(squared distance (B, P), index (B, P) int32) of the nearest valid
    reference per query; both carry no gradient."""
    q = query_bxpx3.detach()
    r = points_bxmx3.detach()
    n_valid, n_queries = _defaults(q, r, n_valid, n_queries)
    _check(q, r, n_valid, n_queries)
    return nearest_neighbor_plain(q, r, n_valid, n_queries)


def sided_squared_distance(a_bxnx3, b_bxmx3, n_valid_b=None, n_valid_a=None):
    """Differentiable one-sided squared distance a -> b: the argmin runs
    without autograd, the distance is recomputed through the gather of
    the nearest point, so gradients reach both clouds.  The index is kept
    for a rematerialized backward (``remat.saved``).  The clouds may be
    strided views (a prefix of stored samples): the kernel reads them
    contiguous."""
    idx = saved("nn_argmin_idx", lambda: nearest_neighbor(
        a_bxnx3.contiguous(), b_bxmx3.contiguous(), n_valid_b,
        n_queries=n_valid_a)[1])
    closest = torch.gather(
        b_bxmx3, 1, idx.long()[..., None].expand(-1, -1, 3)
    )
    return torch.sum((a_bxnx3 - closest) ** 2, dim=-1), idx
