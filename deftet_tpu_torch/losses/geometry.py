"""Per-tet and per-vertex regularizers (torch port of
deftet_tpu/losses/geometry.py): the structure-of-arrays forms of the
3D-supervised step, the array-of-structures forms (the 2D-supervised grid
motion's volume variance, and the package's exported AMIPS and edge
terms), and the padded-gather neighbour mean and Laplacian of a general
grid.

``soa[k][c]`` is a (B, T) tensor holding coordinate c of tet corner k.
"""

from __future__ import annotations

import torch

from ..ops.geometry import det3x3, incidence_gather, tet_edge_matrix

EPS = 1e-10


def gather_tet_soa(pos_bxnx3: torch.Tensor, tet_tx4: torch.Tensor,
                   vert_tet_inc=None):
    """Corner coordinates of the listed tets by gather.  With
    ``vert_tet_inc`` = (inc_idx, inc_mask), the vertex -> tet-corner
    incidence of ``tet_tx4``, each coordinate is one k-major
    ``incidence_gather`` whose backward gathers over the incidence."""
    idx = tet_tx4.long()
    if vert_tet_inc is None:
        return [[pos_bxnx3[:, idx[:, k], c] for c in range(3)]
                for k in range(4)]
    inc_idx, inc_mask = vert_tet_inc
    t = idx.shape[0]
    flat = idx.t().reshape(-1)  # k-major (4T,)
    soa = [[None] * 3 for _ in range(4)]
    for c in range(3):
        vals = incidence_gather(pos_bxnx3[..., c], flat, inc_idx, inc_mask)
        for k in range(4):
            soa[k][c] = vals[:, k * t:(k + 1) * t]
    return soa


def gather_tet_soa_lattice(pos_bxnx3: torch.Tensor, res: int, offsets):
    """Corners of the type-major regular grid as contiguous slices of the
    (B, n, n, n) vertex lattice — no gathers.  ``offsets`` is the
    (6, 4, 3) table of tetgrid.lattice_tet_offsets."""
    r = int(res)
    n = r + 1
    b = pos_bxnx3.shape[0]
    grid = pos_bxnx3.reshape(b, n, n, n, 3)
    slices = {}
    for ty in range(6):
        for k in range(4):
            off = tuple(offsets[ty][k])
            if off not in slices:
                di, dj, dk = off
                sl = grid[:, di:di + r, dj:dj + r, dk:dk + r, :].reshape(
                    b, r**3, 3)
                slices[off] = [sl[..., c] for c in range(3)]
    return [
        [torch.cat([slices[tuple(offsets[ty][k])][c] for ty in range(6)],
                   dim=1) for c in range(3)]
        for k in range(4)
    ]


def tet_centers_soa(soa):
    """Mean of the 4 corners; three (B, T) tensors."""
    return [(soa[0][c] + soa[1][c] + soa[2][c] + soa[3][c]) * 0.25
            for c in range(3)]


def _det3_soa(m):
    return (
        m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
        - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
        + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])
    )


def tet_volumes_soa(soa):
    """Signed volume V = -det([A-D, B-D, C-D]) / 6, (B, T)."""
    rows = [[soa[k][c] - soa[3][c] for c in range(3)] for k in range(3)]
    return -_det3_soa(rows) / 6.0


def volume_variance_soa(soa, pow: int = 4) -> torch.Tensor:
    v = tet_volumes_soa(soa)
    dv = v - v.mean(dim=-1, keepdim=True)
    if pow == 1:
        return dv.abs().sum(dim=-1)
    return (dv**pow).sum(dim=-1)


def tet_volumes(tet_bxtx4x3: torch.Tensor) -> torch.Tensor:
    """Signed volume per tet of (B, T, 4, 3) corners, V = -det([A-D, B-D,
    C-D]) / 6."""
    d = tet_bxtx4x3[..., 3, :]
    rows = [[tet_bxtx4x3[..., k, c] - d[..., c] for c in range(3)]
            for k in range(3)]
    return -_det3_soa(rows) / 6.0


def volume_variance(tet_bxtx4x3: torch.Tensor, pow: int = 4) -> torch.Tensor:
    """Sum over tets of (V - mean V)^pow per batch element."""
    v = tet_volumes(tet_bxtx4x3)
    dv = v - v.mean(dim=-1, keepdim=True)
    if pow == 1:
        return dv.abs().sum(dim=-1)
    return (dv**pow).sum(dim=-1)


def amips_energy_soa(soa, rest_inverse_tx3x3: torch.Tensor,
                     scale: float = 20.0) -> torch.Tensor:
    """Mean AMIPS energy per batch element: J = edge_matrix @ rest_inverse,
    trace(J^T J) * (det^2 + eps)^(-1/3) where det >= 0."""
    edge = [[(soa[k + 1][c] - soa[0][c]) * scale for c in range(3)]
            for k in range(3)]
    inv = [[rest_inverse_tx3x3[:, k, j][None] for j in range(3)]
           for k in range(3)]
    jac = [
        [edge[i][0] * inv[0][j] + edge[i][1] * inv[1][j]
         + edge[i][2] * inv[2][j] for j in range(3)]
        for i in range(3)
    ]
    trace = sum(jac[i][j] * jac[i][j] for i in range(3) for j in range(3))
    det = _det3_soa(jac)
    pos_det = (det >= 0.0).to(trace.dtype)
    energy = trace * torch.pow(det * det + EPS, -1.0 / 3.0) * pos_det
    return energy.mean(dim=-1)


def edge_length_soa(soa, pow: int = 4, scale: float = 20.0) -> torch.Tensor:
    pairs = [(0, 3), (1, 3), (2, 3), (0, 1), (0, 2), (1, 2)]
    total = 0.0
    for a, b in pairs:
        for c in range(3):
            total = total + ((soa[a][c] * scale - soa[b][c] * scale)
                             ** pow).sum(dim=-1)
    return total / (6 * soa[0][0].shape[-1])


def delta_loss(pos_delta_bxnx3: torch.Tensor) -> torch.Tensor:
    """Mean absolute offset per batch element."""
    return pos_delta_bxnx3.abs().mean(dim=(-1, -2))


def amips_energy(tet_bxtx4x3: torch.Tensor, rest_inverse_tx3x3: torch.Tensor,
                 scale: float = 20.0, square: bool = False) -> torch.Tensor:
    """AMIPS energy of (B, T, 4, 3) corners averaged over tets: J = edge
    matrix @ rest inverse, trace(J^T J) (det^2 + eps)^(-1/3) where
    det >= 0."""
    jac = torch.einsum("btij,tjk->btik",
                       tet_edge_matrix(tet_bxtx4x3, scale=scale),
                       rest_inverse_tx3x3)
    trace = torch.sum(jac * jac, dim=(-1, -2))
    det = det3x3(jac)
    pos_det = (det >= 0.0).to(jac.dtype)
    energy = trace * torch.pow(det * det + EPS, -1.0 / 3.0) * pos_det
    if square:
        energy = energy**2
    return energy.mean(dim=-1)


def edge_length(tet_bxtx4x3: torch.Tensor, pow: int = 4,
                scale: float = 20.0) -> torch.Tensor:
    """Mean over tets of the summed elementwise pow of the 6 scaled
    edges, of (B, T, 4, 3) corners."""
    p = [tet_bxtx4x3[..., k, :] * scale for k in range(4)]
    total = 0.0
    for a, b in ((0, 3), (1, 3), (2, 3), (0, 1), (0, 2), (1, 2)):
        total = total + torch.sum((p[a] - p[b]) ** pow, dim=(-1, -2))
    return total / (6 * tet_bxtx4x3.shape[-3])


class _NeighborMean(torch.autograd.Function):
    """Mean over the padded neighbour lists.  The adjacency is symmetric
    (j lists i iff i lists j), so the backward is the same padded sum of
    the cotangent divided by each row's degree: gathers, no scatter."""

    @staticmethod
    def forward(ctx, x_bxnxd, idx_nxm, deg_n):
        ctx.save_for_backward(idx_nxm, deg_n)
        ctx.dtype = x_bxnxd.dtype
        return _padded_sum(x_bxnxd, idx_nxm) / deg_n[None, :, None]

    @staticmethod
    def backward(ctx, g_bxnxd):
        idx, deg = ctx.saved_tensors
        grad = _padded_sum(g_bxnxd / deg[None, :, None], idx)
        return grad.to(ctx.dtype), None, None


def _padded_sum(x_bxnxd, idx_nxm):
    """sum_m x[:, idx[:, m]] in float32, where an index of N (past the
    last vertex) reads zero: per batch element one gather of the (N, M, D)
    block at x's precision from x with a zero row appended, then its
    float32 sum over m.  One element at a time, the block is 1.09 GB at
    res 50, D 256, bf16 (2.17 GB for a float32 cotangent)."""
    b, n, d = x_bxnxd.shape
    out = torch.empty((b, n, d), dtype=torch.float32, device=x_bxnxd.device)
    zero = x_bxnxd.new_zeros((1, d))
    flat = idx_nxm.reshape(-1)
    for i in range(b):
        block = torch.index_select(torch.cat([x_bxnxd[i], zero]), 0, flat)
        torch.sum(block.view(n, -1, d), dim=1, dtype=torch.float32,
                  out=out[i])
    return out


def neighbor_mean(x_bxnxd: torch.Tensor, adj_idx_nxm: torch.Tensor,
                  adj_mask_nxm: torch.Tensor,
                  degree_n: torch.Tensor) -> torch.Tensor:
    """Row-normalized adjacency matmul as a padded gather: out[i] = the
    mean over neighbours j of x[j], (B, N, D) float32 whatever x's dtype
    (the JAX package's sum of x times the float32 mask is float32).  The
    mask marks the valid slots (1) of each padded list (0 after them); the
    degree is rounded to x's dtype first, as there."""
    deg = torch.clamp(degree_n, min=1).to(x_bxnxd.dtype).float()
    idx = torch.where(adj_mask_nxm > 0, adj_idx_nxm,
                      torch.full_like(adj_idx_nxm, x_bxnxd.shape[1]))
    return _NeighborMean.apply(x_bxnxd, idx, deg)


def laplacian_loss(offset_bxnx3: torch.Tensor, adj_idx_nxm: torch.Tensor,
                   adj_mask_nxm: torch.Tensor,
                   degree_n: torch.Tensor) -> torch.Tensor:
    """sum_i || mean_j offset[j] - offset[i] ||^2 per batch element."""
    nei = neighbor_mean(offset_bxnx3, adj_idx_nxm, adj_mask_nxm, degree_n)
    return torch.sum((nei - offset_bxnx3) ** 2, dim=(-1, -2))
