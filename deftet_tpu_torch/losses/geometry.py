"""Per-tet regularizers (torch port of deftet_tpu/losses/geometry.py):
the structure-of-arrays forms of the 3D-supervised step, and the
array-of-structures volume variance of the 2D-supervised grid motion.

``soa[k][c]`` is a (B, T) tensor holding coordinate c of tet corner k.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def gather_tet_soa(pos_bxnx3: torch.Tensor, tet_tx4: torch.Tensor):
    """Corner coordinates of the listed tets by gather."""
    idx = tet_tx4.long()
    return [[pos_bxnx3[:, idx[:, k], c] for c in range(3)] for k in range(4)]


def gather_tet_soa_lattice(pos_bxnx3: torch.Tensor, res: int, offsets):
    """Corners of the type-major regular grid as contiguous slices of the
    (B, n, n, n) vertex lattice — no gathers.  ``offsets`` is the
    (6, 4, 3) table of train.statics.lattice_tet_offsets."""
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
