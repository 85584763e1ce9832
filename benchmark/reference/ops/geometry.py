"""Small batched 3D geometry primitives (torch port of
deftet_tpu/ops/geometry.py): determinants, the guarded 3x3 inverse, the
AMIPS rest-pose frames, face normals, and the two static-index gathers of
the general-grid step whose backward is a gather too (``incidence_gather``,
``edge_face_sum``): no scatter-add, so no atomics, and the gradient
follows one fixed summation order on every device."""

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


def gather_tet_vertices(verts_bxnx3: torch.Tensor,
                        tet_tx4: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) positions and (T, 4) indices -> (B, T, 4, 3)."""
    return verts_bxnx3[:, tet_tx4.long()]


def face_normals(face_bxfx3x3: torch.Tensor, eps: float = 1e-12):
    """Unit normals of triangles (..., 3 corners, 3)."""
    a, b, c = (face_bxfx3x3[..., k, :] for k in range(3))
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + eps)


class _IncidenceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values_bxn, idx_flat_k, inc_idx_nxm, inc_mask_nxm):
        ctx.save_for_backward(inc_idx_nxm, inc_mask_nxm)
        ctx.dtype = values_bxn.dtype
        return values_bxn[:, idx_flat_k]

    @staticmethod
    def backward(ctx, g_bxk):
        inc_idx, inc_mask = ctx.saved_tensors
        gathered = g_bxk[:, inc_idx.reshape(-1)].reshape(
            g_bxk.shape[0], *inc_idx.shape)
        grad = (gathered * inc_mask[None]).sum(dim=-1)
        return grad.to(ctx.dtype), None, None, None


def incidence_gather(values_bxn: torch.Tensor, idx_flat_k: torch.Tensor,
                     inc_idx_nxm: torch.Tensor, inc_mask_nxm: torch.Tensor):
    """``values[:, idx_flat]`` (B, K), whose backward gathers the
    cotangent over the transpose table (tetgrid.topology's vertex ->
    corner incidence: value n was read at slots ``inc_idx[n, m]`` where
    ``inc_mask[n, m]`` is 1) and takes the mask-weighted sum over m."""
    return _IncidenceGather.apply(values_bxn, idx_flat_k, inc_idx_nxm,
                                  inc_mask_nxm)


class _EdgeFaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_bxf, edge_face_idx, edge_face_mask, face_edge_ids):
        ctx.save_for_backward(face_edge_ids)
        ctx.x_dtype = x_bxf.dtype
        # a bf16 field times the float32 mask is a float32 product
        out = torch.zeros((x_bxf.shape[0], edge_face_idx.shape[0]),
                          dtype=torch.float32, device=x_bxf.device)
        for m in range(edge_face_idx.shape[1]):
            out.addcmul_(torch.index_select(x_bxf, 1, edge_face_idx[:, m]),
                         edge_face_mask[None, :, m])
        return out

    @staticmethod
    def backward(ctx, g_bxe):
        (fei,) = ctx.saved_tensors
        f = fei.shape[0]
        # slot-major ids: the per-face sum is three (B, F) slices, summed
        # in float32 from the cotangent at the field's precision
        g3 = g_bxe.to(ctx.x_dtype)[:, fei.t().reshape(-1)]
        total = (g3[:, :f].float() + g3[:, f:2 * f].float()
                 + g3[:, 2 * f:].float())
        return total.to(ctx.x_dtype), None, None, None


def edge_face_sum(x_bxf: torch.Tensor, edge_face_idx: torch.Tensor,
                  edge_face_mask: torch.Tensor, face_edge_ids: torch.Tensor):
    """(B, E) float32 per-edge sums ``sum_m x[:, edge_face_idx[e, m]] *
    mask[e, m]``, taken over m in order; the backward gathers the
    cotangent at each face's three edge ids (every face lies on exactly
    three edges)."""
    return _EdgeFaceSum.apply(x_bxf, edge_face_idx, edge_face_mask,
                              face_edge_ids)
