"""Point-in-tetrahedron query: the first (lowest-index) tet containing each
point, or -1 (torch port of deftet_tpu/ops/point_tet.py).

Four same-side tests per (point, tet): the plane through three corners,
with the query and the fourth corner on one side.  The JAX package runs
this scan in XLA over every (point, tet) pair.  On a CUDA tensor the port
launches ``csrc/point_tet.cu``, which bins the tets' padded corner boxes
on a uniform grid and tests each point against its cell's candidates and
a short overflow list (tets whose padding is unproved or whose box covers
too many cells); a proof in the source bounds the padding, so no hit is
lost.  On a CPU tensor it runs ``points_in_tets_plain``, the scan chunked
over queries and tets so that no (P, T) array is whole.  Both keep the
JAX package's expressions in its order, so indices agree bit for bit.
No gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda

_KERNEL = "point_tet"
_BIG = 2**30
TETS_PER_CELL = 8   # the kernel's grid has at most T / 8 cells an element
PAD_SHARE = 2.0**-12  # the kernel's least padding, of the grid's scale


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


def inside_block(planes, bi: int, q_px3: torch.Tensor,
                 tets: slice) -> torch.Tensor:
    """(P, len(tets)) bool: all four same-side tests of each query of batch
    element ``bi`` against each tet of the slice."""
    qx, qy, qz = (q_px3[:, c, None] for c in range(3))
    inside = None
    for nx, ny, nz, off, ref in planes:
        qd = (qx * nx[bi, None, tets] + qy * ny[bi, None, tets]
              + qz * nz[bi, None, tets] - off[bi, None, tets])
        ok = qd * ref[bi, None, tets] >= 0.0
        inside = ok if inside is None else inside & ok
    return inside


@torch.no_grad()
def points_in_tets_plain(soa, query_bxpx3: torch.Tensor, chunk: int = 4096,
                         query_chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of ``points_in_tets_soa``: every query against
    every tet, in blocks of ``query_chunk`` x ``chunk``."""
    q = query_bxpx3.detach().float()
    b, p, _ = q.shape
    planes = _planes(soa)
    t = planes[0][0].shape[1]
    found = torch.full((b, p), _BIG, dtype=torch.int64, device=q.device)
    for bi in range(b):
        for qs in range(0, p, query_chunk):
            best = found[bi, qs:qs + query_chunk]
            for ts in range(0, t, chunk):
                inside = inside_block(planes, bi, q[bi, qs:qs + query_chunk],
                                      slice(ts, ts + chunk))
                hit = inside.any(dim=1)
                first = ts + inside.to(torch.uint8).argmax(dim=1)
                cand = torch.where(hit, first, torch.full_like(first, _BIG))
                torch.minimum(best, cand, out=best)
    return torch.where(found == _BIG, torch.full_like(found, -1),
                       found).to(torch.int32)


def bin_cells(x: torch.Tensor, origin, inv, n: int) -> torch.Tensor:
    """int32 cell of each coordinate ``x`` on one axis of the kernel's bin
    grid: floor((x - origin) * inv) in float32, clamped to [0, n - 1], NaN
    to 0; monotone in ``x`` (``cell_of`` in csrc/point_tet.cu)."""
    x = x.float()
    t = torch.floor((x - torch.as_tensor(origin, dtype=torch.float32))
                    * torch.as_tensor(inv, dtype=torch.float32))
    t = torch.fmax(t, torch.zeros((), dtype=torch.float32))
    return torch.fmin(t, torch.full((), n - 1, dtype=torch.float32)).to(
        torch.int32)


def padded_cell_range(lo: torch.Tensor, hi: torch.Tensor, pad, origin, inv,
                      n: int):
    """(first, last) cells of the boxes [lo, hi] on one axis, each padded by
    ``pad`` and rounded outward by one float step (``tet_cells`` in
    csrc/point_tet.cu): every point within ``pad`` of a box maps to a cell
    in its range."""
    lo, hi = lo.float(), hi.float()
    pad = torch.as_tensor(pad, dtype=torch.float32)
    down = torch.nextafter(lo - pad, torch.full_like(lo, -math.inf))
    up = torch.nextafter(hi + pad, torch.full_like(hi, math.inf))
    return bin_cells(down, origin, inv, n), bin_cells(up, origin, inv, n)


_STAT_KEYS = ("entries", "overflow_tets", "candidates", "max_candidates",
              "queries", "found", "all_tets_queries")
_last_stats = None  # the last launch's device stats record


def kernel_stats() -> dict | None:
    """The last kernel call's stats record, read to the host here (never on
    the main path): entries binned, overflow tets, mean and maximum
    candidates a query (cell list + overflow list), the share of queries
    inside a tet, and the queries that scanned every tet (an infinite or
    huge coordinate).  None before any call."""
    if _last_stats is None:
        return None
    v = dict(zip(_STAT_KEYS, (int(x) for x in _last_stats.tolist())))
    q = max(v["queries"], 1)
    return {"entries": v["entries"] - v["overflow_tets"],
            "overflow_tets": v["overflow_tets"],
            "mean_candidates": v["candidates"] / q,
            "max_candidates": v["max_candidates"],
            "queries": v["queries"], "found_share": v["found"] / q,
            "all_tets_queries": v["all_tets_queries"]}


def _points_in_tets_cuda(soa, q):
    global _last_stats
    corners = []
    for k in range(4):
        for c in range(3):
            x = soa[k][c].detach().float()
            corners.append(x if x.stride(-1) == 1 else x.contiguous())
    b, p, _ = q.shape
    t = corners[0].shape[1]
    for x in corners:
        if x.shape != (b, t) or x.device != q.device:
            raise ValueError("point_tet needs (B, T) corners beside (B, P, 3) "
                             "queries on one device")
    q = q.float().contiguous()
    out = torch.empty((b, p), dtype=torch.int32, device=q.device)
    if b * p == 0:
        return out
    if t == 0:
        return out.fill_(-1)
    cmax = max(1, t // TETS_PER_CELL)
    slots = b * (cmax + 1)
    lib = _cuda.library(_KERNEL)
    ws_bytes = lib.deftet_point_tet_workspace_bytes(b, slots)
    if ws_bytes < 0:
        raise ValueError(f"point_tet: {b} x {t} tets need too many bins")
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    ends = torch.empty(slots, dtype=torch.int64, device=q.device)
    stats = torch.empty(8, dtype=torch.int64, device=q.device)
    boxes = torch.empty(b * t * 8, dtype=torch.float32, device=q.device)
    ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in corners))
    strides = (ctypes.c_longlong * 12)(*(x.stride(0) for x in corners))
    stream = _cuda.stream_handle(q.device)
    with torch.cuda.device(q.device):
        err = lib.deftet_point_tet_bin(ptrs, strides, ws.data_ptr(),
                                       ends.data_ptr(), stats.data_ptr(), b,
                                       t, cmax, stream)
        _cuda.check(lib, err, _KERNEL)
        n_entries = int(stats[0])  # the call's one read to the host
        entries = torch.empty(max(n_entries, 1), dtype=torch.int32,
                              device=q.device)
        err = lib.deftet_point_tet_query(
            ptrs, strides, ws.data_ptr(), ends.data_ptr(),
            entries.data_ptr(), boxes.data_ptr(), q.data_ptr(),
            out.data_ptr(), stats.data_ptr(), b, p, t, cmax, stream)
    _cuda.check(lib, err, _KERNEL)
    _cuda.count_launch(_KERNEL)
    _last_stats = stats
    return out


@torch.no_grad()
def points_in_tets_soa(soa, query_bxpx3: torch.Tensor, chunk: int = 4096,
                       query_chunk: int = 4096) -> torch.Tensor:
    """(B, P) int32 first containing tet per point, or -1.  ``soa`` is the
    corner structure of ``losses.geometry.gather_tet_soa``:
    soa[k][c] = (B, T).  ``chunk`` and ``query_chunk`` block the plain
    version's scan (CPU only)."""
    q = query_bxpx3.detach()
    if q.device.type == "cuda":
        return _points_in_tets_cuda(soa, q)
    if q.device.type == "cpu":
        return points_in_tets_plain(soa, q, chunk, query_chunk)
    raise RuntimeError(f"no point-in-tet implementation for {q.device}")


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
