"""Surface losses over the boundary faces (torch port of
deftet_tpu/losses/surface.py).

Boundary faces come as a per-face (mask, sign) over the static face list
(class-major on the lattice).  With a budget ``0 < k < F`` the first
``k`` boundary faces (face order, NOT a uniform sample — the JAX package
keeps first-k too) form a static working set; with ``k = 0`` (or
``k >= F``) the working set is every face under the mask.  The terms:

  * Chamfer  — sqrt-uv barycentric samples on each working face -> GT
    points, through the nearest-neighbour kernel (K2);
  * analytic — GT points -> nearest working face, through the
    triangle-argmin kernel (K3);
  * normal   — (1 - n_a . n_b) over edge-sharing boundary pairs by the
    per-edge closed form: on the compacted set summed as lattice slices
    or, on a general grid, by ``edge_face_sum``; uncompacted from every
    face's normal over ``edge_face_sum`` (``normal_smoothness_loss``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import parallel
from ..ops.geometry import edge_face_sum, incidence_gather
from ..ops.lattice import lattice_boundary_info, lattice_edge_quadratics
from ..ops.nearest import sided_squared_distance
from ..ops.tri_distance import point_to_mesh_squared_distance
from ..remat import saved

EPS = 1e-10
# the normal term's per-face fields are scattered and slice-summed in this
# dtype, as the JAX package's are (bf16 whatever the network's precision)
NORMAL_FIELD_DTYPE = torch.bfloat16


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


def boundary_info_from_occupancy(occ_bxt: torch.Tensor,
                                 face_tet_fx2: torch.Tensor):
    """(mask (B, F), sign (B, F)) of a face list by gathering its owners'
    occupancies: a face is boundary iff exactly one owner is occupied, and
    sign is -1 where the first owner is (its orientation flips)."""
    occ_a = occ_bxt[:, face_tet_fx2[:, 0]]
    occ_b = occ_bxt[:, face_tet_fx2[:, 1]]
    mask = ((occ_a + occ_b) == 1.0).to(torch.float32)
    return mask, 1.0 - 2.0 * occ_a


def boundary_faces_from_occupancy(occ_bxt: torch.Tensor,
                                  face_fx3: torch.Tensor,
                                  face_tet_fx2: torch.Tensor,
                                  face_lattice=None):
    """Oriented boundary faces and their mask from per-tet occupancy: a
    face is boundary iff exactly one of its two owners is occupied, and
    its vertex order flips where the first owner is (sign -1).  The
    owners' occupancies are lattice slices with ``face_lattice`` (the
    class-major layout), else gathers.  Returns (faces (B, F, 3) int64,
    mask (B, F))."""
    if face_lattice is not None:
        mask, sign = lattice_boundary_info(occ_bxt, face_lattice)
    else:
        mask, sign = boundary_info_from_occupancy(occ_bxt, face_tet_fx2)
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


def _face_normals_soa_static(tet_pos_bxnx3, face_fx3, inc_idx_nxm,
                             inc_mask_nxm, eps: float = 1e-12):
    """Unit normals of the static-orientation faces as three (B, F)
    components, through one ``incidence_gather`` of all three coordinates
    (folded into the batch axis) over the k-major face corners."""
    f = face_fx3.shape[0]
    b = tet_pos_bxnx3.shape[0]
    stacked = tet_pos_bxnx3.transpose(1, 2).reshape(3 * b, -1)
    vals = incidence_gather(stacked, face_fx3.t().reshape(-1), inc_idx_nxm,
                            inc_mask_nxm).reshape(b, 3, -1)
    comps = [[vals[:, c, k * f:(k + 1) * f] for k in range(3)]
             for c in range(3)]
    e1 = [comps[c][1] - comps[c][0] for c in range(3)]
    e2 = [comps[c][2] - comps[c][0] for c in range(3)]
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + eps)
    return nx * inv, ny * inv, nz * inv


def _quadratics_mean(total, count):
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.zeros_like(total))


def normal_smoothness_loss(tet_pos_bxnx3, face_fx3, boundary_mask_bxf,
                           boundary_sign_bxf, edge_topo) -> torch.Tensor:
    """Mean (1 - n_a . n_b) over pairs of boundary faces sharing an edge,
    0 where there is none, over every face (the uncompacted form).  The
    normals are the static faces', the flip entering as the sign folded
    into the weights; per edge ``sum_{i!=j} w_i w_j (1 - n_i.n_j) = s_w^2 -
    |s_wsn|^2`` and ``sum_{i!=j} w_i w_j = s_w^2 - s_w2``, the five
    per-edge sums one float32 ``edge_face_sum``.  ``edge_topo`` =
    (edge_face_idx, edge_face_mask, face_edge_ids, vert_face_inc_idx,
    vert_face_inc_mask)."""
    edge_face_idx, edge_face_mask, face_edge_ids, inc_idx, inc_mask = \
        edge_topo
    b = tet_pos_bxnx3.shape[0]
    if edge_face_idx.shape[0] == 0:
        return torch.zeros((b,), device=tet_pos_bxnx3.device)
    nx, ny, nz = _face_normals_soa_static(tet_pos_bxnx3, face_fx3, inc_idx,
                                          inc_mask)
    w = boundary_mask_bxf.detach()
    ws = w * boundary_sign_bxf.detach()
    fields = torch.cat([w, w * w, ws * nx, ws * ny, ws * nz], dim=0)
    sums = edge_face_sum(fields, edge_face_idx, edge_face_mask,
                         face_edge_ids).reshape(5, b, -1)
    s_w, s_w2, s_nx, s_ny, s_nz = sums.unbind(0)
    total = torch.sum(s_w * s_w - (s_nx * s_nx + s_ny * s_ny + s_nz * s_nz),
                      dim=1)
    count = torch.sum(s_w * s_w - s_w2, dim=1)
    return _quadratics_mean(total, count)


def normal_smoothness_loss_compacted(work_pos_bxkx3x3, sel_idx_bxk,
                                     sel_mask_bxk, boundary_mask_bxf,
                                     boundary_sign_bxf, face_lattice=None,
                                     edge_topo=None,
                                     eps: float = 1e-12) -> torch.Tensor:
    """Mean (1 - n_a . n_b) over edge-sharing pairs of the selected
    boundary faces; 0 when there is no pair.  Normals are computed on the
    selection only and scattered (unique slots) back to the face axis in
    ``NORMAL_FIELD_DTYPE`` (bf16); the per-edge sums run as lattice
    slices with ``face_lattice``, else as ``edge_face_sum`` over
    ``edge_topo`` (the mask is binary, so s_w2 = s_w)."""
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
        return torch.zeros((b, f), dtype=NORMAL_FIELD_DTYPE,
                           device=v.device).scatter_add(
            1, sel_idx_bxk, v.to(NORMAL_FIELD_DTYPE))

    rows = [scatter(sel_mask_bxk.detach())]
    rows += [scatter(vals[..., comp]) for comp in range(3)]
    if face_lattice is not None:
        return _quadratics_mean(*lattice_edge_quadratics(*rows, face_lattice))
    edge_face_idx, edge_face_mask, face_edge_ids = edge_topo[:3]
    if edge_face_idx.shape[0] == 0:
        return torch.zeros((b,), device=work_pos_bxkx3x3.device)
    sums = edge_face_sum(torch.cat(rows, dim=0), edge_face_idx,
                         edge_face_mask, face_edge_ids).reshape(4, b, -1)
    s_w, s_nx, s_ny, s_nz = sums.unbind(0)
    total = torch.sum(s_w * s_w - (s_nx * s_nx + s_ny * s_ny + s_nz * s_nz),
                      dim=1)
    return _quadratics_mean(total, torch.sum(s_w * s_w - s_w, dim=1))


def normal_smoothness_loss_pairs(tet_pos_bxnx3, faces_bxfx3,
                                 boundary_mask_bxf, pair_a_p,
                                 pair_b_p) -> torch.Tensor:
    """The explicit-pair form (the oracle of the per-edge closed forms):
    mean (1 - n_a . n_b) over the listed face pairs where both are
    boundary faces."""
    b = tet_pos_bxnx3.shape[0]
    if pair_a_p.shape[0] == 0:
        return torch.zeros((b,), device=tet_pos_bxnx3.device)
    b_idx = torch.arange(b, device=tet_pos_bxnx3.device)[:, None, None]
    a, bb, c = (tet_pos_bxnx3[b_idx, faces_bxfx3.long()][:, :, k]
                for k in range(3))
    n = torch.linalg.cross(bb - a, c - a, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    pa, pb = pair_a_p.long(), pair_b_p.long()
    dot = torch.sum(n[:, pa] * n[:, pb], dim=-1)
    w = boundary_mask_bxf[:, pa] * boundary_mask_bxf[:, pb]
    return _quadratics_mean(torch.sum((1.0 - dot) * w, dim=1),
                            torch.sum(w, dim=1))


def surface_align_losses(
    tet_pos_bxnx3,
    face_fx3,
    boundary_mask_bxf,
    boundary_sign_bxf,
    gt_surface_bxsx3,
    face_lattice=None,
    per_face_samples: int = 20,
    max_boundary_faces: int = 0,
    with_chamfer: bool = True,
    with_analytic: bool = True,
    with_normal: bool = True,
    samples_cap: int = 0,
    generator: torch.Generator | None = None,
    bary=None,
    edge_topo=None,
):
    """(chamfer (B,), analytic (B,), normal (B,)); each term is 1.0 for a
    sample with no boundary face.

    ``0 < max_boundary_faces < F`` compacts the working set to the first
    k boundary faces; otherwise it is every face under the mask (K2 then
    scans every face's samples, K3 every face).  ``face_lattice`` (the
    class-major layout) sums the compacted normal term as lattice slices;
    without it, and for the uncompacted term, ``edge_topo`` (see
    ``normal_smoothness_loss``) gives the gather tables.  ``bary`` =
    (u_raw, v) uniforms of shape (B, k, per_face, 1), k the working set's
    size and per_face the count after ``samples_cap``, replaces the draws
    from ``generator`` (tests inject the reference's draws).
    """
    b = tet_pos_bxnx3.shape[0]
    n_boundary = boundary_mask_bxf.sum(dim=1)
    zero = torch.zeros_like(n_boundary)
    compacted = 0 < max_boundary_faces < face_fx3.shape[0]
    if with_normal and (not compacted or face_lattice is None) and (
            edge_topo is None or edge_topo[0] is None):
        raise ValueError("the normal term needs the edge arrays: build the "
                         "statics with face_arrays=True")

    if compacted:
        work_faces, work_mask, work_idx = select_boundary_subset_static(
            face_fx3, boundary_mask_bxf, max_boundary_faces)
        b_idx = torch.arange(b, device=tet_pos_bxnx3.device)[:, None, None]
        work_pos = tet_pos_bxnx3[b_idx, work_faces]  # (B, k, 3, 3)
    elif with_chamfer or with_analytic:
        work_pos = tet_pos_bxnx3[:, face_fx3]  # (B, F, 3, 3)
        work_mask = boundary_mask_bxf

    normal = zero
    if with_normal and compacted:
        normal = normal_smoothness_loss_compacted(
            work_pos, work_idx, work_mask, boundary_mask_bxf,
            boundary_sign_bxf, face_lattice=face_lattice,
            edge_topo=edge_topo)
    elif with_normal:
        normal = normal_smoothness_loss(tet_pos_bxnx3, face_fx3,
                                        boundary_mask_bxf, boundary_sign_bxf,
                                        edge_topo)

    chamfer = zero
    if with_chamfer:
        n_work = work_pos.shape[1]
        per_face = per_face_samples
        if samples_cap > 0:
            per_face = max(1, min(per_face_samples,
                                  samples_cap // max(n_work, 1)))
        if bary is None:
            # per example: under a data-parallel shard, this rank's rows
            # of the one-process draw
            dev = tet_pos_bxnx3.device

            def uniform(shape):
                return torch.rand(shape, generator=generator, device=dev)

            shape = (b, n_work, per_face, 1)
            u_raw = parallel.draw_rows(shape, uniform)
            v = parallel.draw_rows(shape, uniform)
        else:
            u_raw, v = bary
        samples = sample_surface_points(work_pos, u_raw, v)
        flat = samples.reshape(b, n_work * per_face, 3)
        # compacted, the real faces are a prefix of the working set: the
        # kernel skips query tiles past the live samples
        n_q = ((work_mask.sum(dim=1) * per_face).to(torch.int32)
               if compacted else None)
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
