"""Small batched 3D geometry primitives (torch port of
deftet_tpu/ops/geometry.py: determinants, the guarded 3x3 inverse and the
AMIPS rest-pose frames)."""

from __future__ import annotations

import torch


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) via the scalar triple product a . (b x c)."""
    a, b, c = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)


def safe_inverse3x3(m: torch.Tensor, eps: float = 1e-10):
    """Adjugate inverse of (..., 3, 3); near-singular inputs are replaced
    by the identity first.  Returns (inverse, valid mask)."""
    det = det3x3(m)
    singular = det.abs() < eps
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)
    m_safe = torch.where(singular[..., None, None], eye, m)
    det_safe = det3x3(m_safe)
    a, b, c = m_safe[..., 0, :], m_safe[..., 1, :], m_safe[..., 2, :]
    cross = torch.linalg.cross
    inv = torch.stack(
        [cross(b, c, dim=-1), cross(c, a, dim=-1), cross(a, b, dim=-1)],
        dim=-1,
    ) / det_safe[..., None, None]
    return inv, 1.0 - singular.to(m.dtype)


def tet_edge_matrix(tet_bxtx4x3: torch.Tensor, scale: float = 20.0):
    """Rows [B-A; C-A; D-A] * scale per tet (the AMIPS Jacobian frame)."""
    a = tet_bxtx4x3[..., 0, :]
    return torch.stack(
        [tet_bxtx4x3[..., k, :] - a for k in (1, 2, 3)], dim=-2
    ) * scale


def tet_rest_inverse(rest_verts_nx3: torch.Tensor, tet_tx4: torch.Tensor,
                     scale: float = 20.0) -> torch.Tensor:
    """Per-tet inverse of the rest-pose edge matrix, (T, 3, 3)."""
    tet = rest_verts_nx3[tet_tx4.long()][None]
    inv, _ = safe_inverse3x3(tet_edge_matrix(tet, scale=scale)[0])
    return inv
