"""Surface losses over the compacted boundary-face subset (torch port of
the compacted path of deftet_tpu/losses/surface.py).

Boundary faces come as a per-face (mask, sign) over the static
class-major face list.  The first ``k`` boundary faces (class-major face
order, NOT a uniform sample — the JAX package keeps first-k too) form a
static working set for the three terms:

  * Chamfer  — sqrt-uv barycentric samples on each working face -> GT
    points, through the nearest-neighbour kernel (K2);
  * analytic — GT points -> nearest working face, through the
    triangle-argmin kernel (K3);
  * normal   — (1 - n_a . n_b) over edge-sharing boundary pairs by the
    per-edge closed form, summed as lattice slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.lattice import lattice_boundary_info, lattice_edge_quadratics
from ..ops.nearest import sided_squared_distance
from ..ops.tri_distance import point_to_mesh_squared_distance
from ..remat import saved

EPS = 1e-10


def sample_surface_points(face_pos_bxfx3x3: torch.Tensor, u_raw: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Uniform samples on each triangle by sqrt-uv barycentrics from
    uniforms ``u_raw``, ``v`` of shape (B, F, K, 1); returns (B, F, K, 3)."""
    u = torch.sqrt(u_raw)
    a = face_pos_bxfx3x3[:, :, None, 0, :]
    bb = face_pos_bxfx3x3[:, :, None, 1, :]
    c = face_pos_bxfx3x3[:, :, None, 2, :]
    return (1 - u) * a + (u * (1 - v)) * bb + u * v * c


def _compact_epilogue(idx, n_bx, k: int, f_total: int, dtype):
    """Clamp indices past the boundary count; first-n validity mask."""
    valid = (torch.arange(k, device=idx.device)[None] < n_bx[:, None]).to(
        dtype)
    return torch.clamp(idx, max=f_total - 1), valid


def _compact_indices(boundary_mask_bxf: torch.Tensor, k: int):
    """First-k stream compaction: (idx (B, k) int64 — clamped garbage past
    the boundary count — and valid (B, k) in the mask's dtype).  The j-th
    boundary face is the first position whose inclusive count reaches j."""
    b, f_total = boundary_mask_bxf.shape
    rank = torch.cumsum((boundary_mask_bxf > 0).to(torch.int32), dim=1)
    targets = torch.arange(1, k + 1, dtype=torch.int32,
                           device=rank.device).expand(b, k).contiguous()
    idx = torch.searchsorted(rank, targets, side="left")
    return _compact_epilogue(idx, rank[:, -1], k, f_total,
                             boundary_mask_bxf.dtype)


def boundary_faces_from_occupancy(occ_bxt: torch.Tensor,
                                  face_fx3: torch.Tensor, face_lattice):
    """Oriented boundary faces and their mask from per-tet occupancy over
    the class-major lattice faces: a face is boundary iff exactly one of
    its two owners is occupied, and its vertex order flips where the first
    owner is (sign -1).  Returns (faces (B, F, 3) int64, mask (B, F))."""
    mask, sign = lattice_boundary_info(occ_bxt, face_lattice)
    faces = torch.where((sign < 0)[..., None], face_fx3.flip(-1)[None],
                        face_fx3[None])
    return faces, mask


def select_boundary_subset(faces_bxfx3, boundary_mask_bxf, max_faces: int):
    """(faces (B, k, 3), mask (B, k)) of the first k boundary faces of a
    per-sample face list; slots past the boundary count have mask 0."""
    k = min(max_faces, boundary_mask_bxf.shape[1])
    idx, valid = _compact_indices(boundary_mask_bxf, k)
    sel_faces = torch.gather(faces_bxfx3, 1, idx[:, :, None].expand(-1, -1, 3))
    sel_mask = torch.gather(boundary_mask_bxf, 1, idx) * valid
    return sel_faces, sel_mask


def select_boundary_subset_static(face_fx3, boundary_mask_bxf,
                                  max_faces: int):
    """(faces (B, k, 3), mask (B, k), idx (B, k)) of the first k boundary
    faces of a batch-invariant face list."""
    k = min(max_faces, boundary_mask_bxf.shape[1])
    idx, valid = saved("boundary_compact_idx", "boundary_compact_valid",
                       lambda: _compact_indices(boundary_mask_bxf, k))
    sel_faces = face_fx3[idx]
    sel_mask = torch.gather(boundary_mask_bxf, 1, idx) * valid
    return sel_faces, sel_mask, idx


def normal_smoothness_loss_compacted(work_pos_bxkx3x3, sel_idx_bxk,
                                     sel_mask_bxk, boundary_mask_bxf,
                                     boundary_sign_bxf, face_lattice,
                                     eps: float = 1e-12) -> torch.Tensor:
    """Mean (1 - n_a . n_b) over edge-sharing pairs of the selected
    boundary faces; 0 when there is no pair.  Normals are computed on the
    selection only and scattered (unique slots) back to the face axis in
    bf16; the per-edge sums run as lattice slices."""
    b, f = boundary_mask_bxf.shape
    a = work_pos_bxkx3x3[:, :, 0, :]
    bb = work_pos_bxkx3x3[:, :, 1, :]
    c = work_pos_bxkx3x3[:, :, 2, :]
    n = torch.linalg.cross(bb - a, c - a, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + eps)

    sign_sel = torch.gather(boundary_sign_bxf, 1, sel_idx_bxk)
    ws = (sel_mask_bxk * sign_sel).detach()
    vals = ws[..., None] * n

    def scatter(v):
        return torch.zeros((b, f), dtype=torch.bfloat16,
                           device=v.device).scatter_add(
            1, sel_idx_bxk, v.to(torch.bfloat16))

    rows = [scatter(sel_mask_bxk.detach())]
    rows += [scatter(vals[..., comp]) for comp in range(3)]
    total, count = lattice_edge_quadratics(*rows, face_lattice)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.zeros_like(total))


def surface_align_losses(
    tet_pos_bxnx3,
    face_fx3,
    boundary_mask_bxf,
    boundary_sign_bxf,
    gt_surface_bxsx3,
    face_lattice,
    per_face_samples: int = 20,
    max_boundary_faces: int = 0,
    with_chamfer: bool = True,
    with_analytic: bool = True,
    with_normal: bool = True,
    samples_cap: int = 0,
    generator: torch.Generator | None = None,
    bary=None,
):
    """(chamfer (B,), analytic (B,), normal (B,)) over the compacted
    boundary subset; each term is 1.0 for a sample with no boundary face.

    ``bary`` = (u_raw, v) uniforms of shape (B, k, per_face, 1) replaces
    the draws from ``generator`` (tests inject the reference's draws).
    """
    b = tet_pos_bxnx3.shape[0]
    n_boundary = boundary_mask_bxf.sum(dim=1)
    zero = torch.zeros_like(n_boundary)
    if not 0 < max_boundary_faces < face_fx3.shape[0]:
        raise NotImplementedError(
            "only the compacted surface path (0 < budget < faces) is ported")

    work_faces, work_mask, work_idx = select_boundary_subset_static(
        face_fx3, boundary_mask_bxf, max_boundary_faces)
    b_idx = torch.arange(b, device=tet_pos_bxnx3.device)[:, None, None]
    work_pos = tet_pos_bxnx3[b_idx, work_faces]  # (B, k, 3, 3)

    normal = zero
    if with_normal:
        normal = normal_smoothness_loss_compacted(
            work_pos, work_idx, work_mask, boundary_mask_bxf,
            boundary_sign_bxf, face_lattice)

    chamfer = zero
    if with_chamfer:
        n_work = work_pos.shape[1]
        per_face = per_face_samples
        if samples_cap > 0:
            per_face = max(1, min(per_face_samples,
                                  samples_cap // max(n_work, 1)))
        if bary is None:
            shape = (b, n_work, per_face, 1)
            dev = tet_pos_bxnx3.device
            u_raw = torch.rand(shape, generator=generator, device=dev)
            v = torch.rand(shape, generator=generator, device=dev)
        else:
            u_raw, v = bary
        samples = sample_surface_points(work_pos, u_raw, v)
        flat = samples.reshape(b, n_work * per_face, 3)
        # real faces are a prefix of the working set: the kernel skips
        # query tiles past the live samples
        n_q = (work_mask.sum(dim=1) * per_face).to(torch.int32)
        d2, _ = sided_squared_distance(flat, gt_surface_bxsx3, n_valid_a=n_q)
        d = torch.sqrt(d2 + EPS).reshape(b, n_work, per_face)
        w = work_mask[:, :, None]
        chamfer = (d * w).sum(dim=(1, 2)) / torch.clamp(
            work_mask.sum(dim=1) * per_face, min=1.0)

    analytic = zero
    if with_analytic:
        d2_gt, _ = point_to_mesh_squared_distance(gt_surface_bxsx3, work_pos,
                                                  work_mask)
        analytic = torch.sqrt(d2_gt + EPS).mean(dim=-1)

    has_boundary = n_boundary > 0
    one = torch.ones_like(n_boundary)
    return (
        torch.where(has_boundary, chamfer, one),
        torch.where(has_boundary, analytic, one),
        torch.where(has_boundary, normal, one),
    )


def occupancy_bce(logits_bxk: torch.Tensor,
                  target_bxk: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits."""
    log_p = F.logsigmoid(logits_bxk)
    log_not_p = F.logsigmoid(-logits_bxk)
    return -torch.mean(target_bxk * log_p + (1.0 - target_bxk) * log_not_p)
