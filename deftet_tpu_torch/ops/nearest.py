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

On a CUDA tensor it launches ``csrc/nearest.cu`` (bounded by f32
arithmetic on the H100, see the source: 8 queries a thread, the argmin
deferred to a rescan of one 32-reference sub-tile, and the reference axis
split over blocks where the query blocks do not fill the card, merged by
the least packed (distance, index) key, which keeps every rule above); on
a CPU tensor it runs ``nearest_neighbor_plain``.  The index is
not differentiable; ``sided_squared_distance`` recomputes the distance
through a gather, as deftet_tpu/ops/nearest.py:122-143 does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..remat import saved
from . import _cuda

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


_PLAN_KEYS = ("query_blocks", "splits", "split_len", "blocks_per_sm",
              "scratch_words")


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, b: int, p: int, m: int) -> tuple:
    lib = _cuda.library(_KERNEL)
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = lib.deftet_nearest_plan(b, p, m, out)
    _cuda.check(lib, err, _KERNEL)
    return tuple(out)


def kernel_plan(q, r) -> dict:
    """The CUDA kernel's launch plan for these clouds on their card: query
    blocks per batch, reference splits and references per split (the
    split count that fills the card best at the kernel's occupancy),
    resident blocks per SM, and the merge scratch in 64-bit words."""
    return dict(zip(_PLAN_KEYS, _plan(q.device.index, q.shape[0],
                                      q.shape[1], r.shape[1])))


def _nearest_cuda(q, r, n_valid, n_queries):
    for name, t in (("queries", q), ("points", r), ("n_valid", n_valid),
                    ("n_queries", n_queries)):
        if not t.is_contiguous():
            raise ValueError(f"nearest kernel needs contiguous {name}")
    b, p, _ = q.shape
    d_out = torch.empty((b, p), dtype=torch.float32, device=q.device)
    i_out = torch.empty((b, p), dtype=torch.int32, device=q.device)
    if b * p == 0:
        return d_out, i_out
    words = kernel_plan(q, r)["scratch_words"]
    scratch = torch.empty(words, dtype=torch.int64, device=q.device)
    lib = _cuda.library(_KERNEL)
    with torch.cuda.device(q.device):
        err = lib.deftet_nearest(
            q.data_ptr(), r.data_ptr(), n_valid.data_ptr(),
            n_queries.data_ptr(), d_out.data_ptr(), i_out.data_ptr(),
            scratch.data_ptr(), words, b, p, r.shape[1],
            _cuda.stream_handle(q.device),
        )
    _cuda.check(lib, err, _KERNEL)
    _cuda.count_launch(_KERNEL)
    return d_out, i_out


def nearest_neighbor(query_bxpx3, points_bxmx3, n_valid=None,
                     n_queries=None):
    """(squared distance (B, P), index (B, P) int32) of the nearest valid
    reference per query; both carry no gradient."""
    q = query_bxpx3.detach()
    r = points_bxmx3.detach()
    n_valid, n_queries = _defaults(q, r, n_valid, n_queries)
    _check(q, r, n_valid, n_queries)
    if q.device.type == "cuda":
        return _nearest_cuda(q, r, n_valid, n_queries)
    if q.device.type == "cpu":
        return nearest_neighbor_plain(q, r, n_valid, n_queries)
    raise RuntimeError(f"no nearest-neighbour implementation for {q.device}")


def sided_squared_distance(a_bxnx3, b_bxmx3, n_valid_b=None, n_valid_a=None):
    """Differentiable one-sided squared distance a -> b: the argmin runs
    without autograd, the distance is recomputed through the gather of
    the nearest point, so gradients reach both clouds.  The index is kept
    for a rematerialized backward (``remat.saved``)."""
    idx = saved("nn_argmin_idx", lambda: nearest_neighbor(
        a_bxnx3, b_bxmx3, n_valid_b, n_queries=n_valid_a)[1])
    closest = torch.gather(
        b_bxmx3, 1, idx.long()[..., None].expand(-1, -1, 3)
    )
    return torch.sum((a_bxnx3 - closest) ** 2, dim=-1), idx
