"""The bin-cell mapping that the point-in-tet kernel (``csrc/point_tet.cu``)
mirrors, on the CPU: monotone and clamped, and every (query, containing
tet) pair of the plain scan's four tests has the query's cell inside the
tet's padded cell range.  The kernel itself is held to the plain scan on
the card (``tests/test_torch_point_tet_kernel.py``)."""

import math

import numpy as np
import torch

from deftet_tpu_torch.ops import point_tet as pt
from deftet_tpu_torch.tetgrid import build_tet_grid


def test_bin_cells_monotone_clamped_and_cover_every_hit():
    rng = np.random.default_rng(5)
    grid = build_tet_grid(4)
    verts = grid.centered_vertices().astype(np.float32)
    # element 0 undeformed, where lattice points lie in several tets;
    # element 1 deformed
    pos = np.stack([verts, verts + rng.uniform(-0.08, 0.08, verts.shape)
                    ]).astype(np.float32)
    corners = torch.tensor(pos[:, grid.tets])  # (B, T, 4, 3)
    axis = np.arange(-0.5, 0.5001, 0.125, dtype=np.float32)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                       -1).reshape(-1, 3)
    q = torch.tensor(np.concatenate(
        [rng.uniform(-0.65, 0.65, (2, 800, 3)).astype(np.float32),
         np.broadcast_to(lattice, (2,) + lattice.shape)], axis=1))
    soa = [[corners[:, :, k, c] for c in range(3)] for k in range(4)]
    planes = pt._planes(soa)
    xs = torch.sort(torch.tensor(np.concatenate([
        rng.uniform(-3.0, 3.0, 500), [-math.inf, math.inf, -0.5, 0.5]]),
        dtype=torch.float32)).values
    pairs = 0
    for bi in range(2):
        inside = pt.inside_block(planes, bi, q[bi], slice(None))
        q_idx, t_idx = torch.nonzero(inside, as_tuple=True)
        pairs += len(q_idx)
        lo, hi = corners[bi].amin(1), corners[bi].amax(1)  # (T, 3)
        origin, top = lo.amin(0), hi.amax(0)
        scale = torch.maximum(torch.maximum(origin.abs(), top.abs()),
                              top - origin).max()
        pad = scale * pt.PAD_SHARE
        for n in (1, 7, 11, 13):
            for k in range(3):
                inv = n / (top[k] - origin[k])
                cells = pt.bin_cells(xs, origin[k], inv, n)
                assert cells.dtype == torch.int32
                assert (cells[1:] >= cells[:-1]).all()
                assert cells.min() >= 0 and cells.max() <= n - 1
                assert pt.bin_cells(torch.tensor([math.nan]), origin[k], inv,
                                    n).item() == 0
                first, last = pt.padded_cell_range(lo[:, k], hi[:, k], pad,
                                                   origin[k], inv, n)
                cq = pt.bin_cells(q[bi, :, k], origin[k], inv, n)
                assert (first[t_idx] <= cq[q_idx]).all()
                assert (cq[q_idx] <= last[t_idx]).all()
    assert pairs > 2 * 800 + 2 * len(lattice)  # points in several tets
