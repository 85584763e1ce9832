"""Inference and metric harness (torch port of deftet_tpu/evals/harness.py).

Per batch:
  * encode the input points (input noise from a generator seeded with
    ``config.seed``, so every evaluation sees the same noise),
  * decode the vertex positions over the grid,
  * full-grid occupancy probabilities in chunks of 100,000 tet centers,
    thresholded at ``occ_threshold``,
  * the predicted surface: boundary faces of the predicted occupancy, the
    first ``8 r^2`` of them kept (``boundary_overflow`` counts the rest),
  * metrics: occupancy IoU on the SDF sample points (each point reads its
    containing tet), the IoU sweep over probability thresholds 0.1-0.5 and
    its maximum ``val_iou_max``, F-score (plain and extended), Chamfer and
    Chamfer-L1 on resampled surface points (K2), and the two-sided
    point-to-mesh Hausdorff (K3).

Surface resampling draws faces from the area-weighted categorical over
the masked faces, then sqrt-uv barycentrics.  ``draws`` injects the face
ids and uniforms (and the input noise) so a test can hand both frameworks
the same numbers.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import TrainConfig
from ..losses.geometry import gather_tet_soa_lattice, tet_centers_soa
from ..losses.surface import (
    boundary_faces_from_occupancy,
    select_boundary_subset,
)
from ..nn.gcn import LatticeAdjacency
from ..ops.point_tet import paste_occupancy, points_in_tets_soa
from ..train.statics import GridStatics
from .metrics import (
    chamfer_distance,
    chamfer_distance_l1,
    f_score,
    hausdorff_distance,
    iou,
)

IOU_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)


def _face_areas(face_pos_bxfx3x3):
    a, b, c = (face_pos_bxfx3x3[:, :, k] for k in range(3))
    cross = torch.linalg.cross(b - a, c - a, dim=-1)
    return 0.5 * torch.sqrt(torch.sum(cross * cross, dim=-1) + 1e-20)


@torch.no_grad()
def sample_mesh_points(face_pos_bxfx3x3: torch.Tensor,
                       face_mask_bxf: torch.Tensor, n_points: int,
                       generator: torch.Generator | None = None,
                       draws=None) -> torch.Tensor:
    """(B, n, 3) area-weighted samples on a masked triangle soup.

    Face ids come from the categorical with weights ``area * mask +
    1e-20`` (``torch.multinomial``), then ``u = sqrt(U1)``, ``v = U2``.
    ``draws`` = (face_id (B, n), u_raw (B, n, 1), v (B, n, 1)) replaces
    the draws from ``generator``."""
    b = face_pos_bxfx3x3.shape[0]
    dev = face_pos_bxfx3x3.device
    if draws is None:
        w = _face_areas(face_pos_bxfx3x3) * face_mask_bxf + 1e-20
        face_id = torch.multinomial(w, n_points, replacement=True,
                                    generator=generator)
        u_raw = torch.rand((b, n_points, 1), generator=generator, device=dev)
        v = torch.rand((b, n_points, 1), generator=generator, device=dev)
    else:
        face_id, u_raw, v = draws
    tri = torch.gather(face_pos_bxfx3x3, 1, face_id.long()[:, :, None, None]
                       .expand(-1, -1, 3, 3))
    u = torch.sqrt(u_raw)
    return ((1 - u) * tri[..., 0, :] + (u * (1 - v)) * tri[..., 1, :]
            + u * v * tri[..., 2, :])


@torch.no_grad()
def decode_occ_full_grid(model, centers_soa, pyramid,
                         chunk: int = 100_000) -> torch.Tensor:
    """(B, T) occupancy logits at every tet center, decoded in chunks of
    ``chunk`` centers; ``centers_soa`` = (cx, cy, cz), each (B, T)."""
    t = centers_soa[0].shape[1]
    out = []
    for s in range(0, t, chunk):
        tile = torch.stack([c[:, s:s + chunk] for c in centers_soa], dim=-1)
        out.append(model.decode_occ(tile, pyramid, train=False))
    return torch.cat(out, dim=1)


def _predict(model, batch, statics: GridStatics, config: TrainConfig,
             lattice_offsets, tet_lattice, noise=None):
    """(tet_pos, soa, logits) of the eval forward over the whole grid."""
    surface = batch["surface_points"]
    bsz = surface.shape[0]
    inp = surface[:, : config.n_point]
    if config.add_input_noise:
        if noise is None:
            gen = torch.Generator(device=inp.device).manual_seed(config.seed)
            noise = torch.randn(inp.shape, generator=gen, device=inp.device)
        inp = inp + config.input_noise * noise
    init_pos = statics.init_pos_nx3[None].expand(bsz, -1, -1)
    pos_mask = statics.pos_mask_nx3[None].expand(bsz, -1, -1)
    pyr_pos, pyr_occ = model.encode(inp, False)
    adj = LatticeAdjacency.from_degree(lattice_offsets, statics.vert_degree)
    _, tet_pos, _ = model.decode_pos(init_pos, pyr_pos, pos_mask, False, adj,
                                     config.res)
    soa = gather_tet_soa_lattice(tet_pos, config.res, tet_lattice)
    logits = decode_occ_full_grid(model, tet_centers_soa(soa), pyr_occ,
                                  chunk=min(100_000, statics.n_tets))
    return tet_pos, soa, logits


def _surface(pred_occ, statics: GridStatics, config: TrainConfig,
             face_lattice):
    faces_b, mask_b = boundary_faces_from_occupancy(
        pred_occ, statics.face_fx3, face_lattice)
    budget = config.resolved_max_boundary_faces() or faces_b.shape[1]
    work_faces, work_mask = select_boundary_subset(faces_b, mask_b, budget)
    return work_faces, work_mask, mask_b, budget


@torch.no_grad()
def extract_predicted_surface(model, batch, statics: GridStatics,
                              config: TrainConfig, lattice_offsets=None,
                              tet_lattice=None, face_lattice=None):
    """(verts (B, N, 3), faces (B, K, 3), mask (B, K)) numpy arrays of the
    predicted surface: the deformed vertices and the boundary faces of the
    thresholded occupancy (for the OBJ dumps)."""
    tet_pos, _, logits = _predict(model, batch, statics, config,
                                  lattice_offsets, tet_lattice)
    pred_occ = (torch.sigmoid(logits) > config.occ_threshold).float()
    work_faces, work_mask, _, _ = _surface(pred_occ, statics, config,
                                           face_lattice)
    return (tet_pos.float().cpu().numpy(), work_faces.cpu().numpy(),
            work_mask.cpu().numpy())


def save_predicted_surface_objs(model, batch, statics, config,
                                out_prefix: str, lattice_offsets=None,
                                tet_lattice=None, face_lattice=None):
    """One OBJ per batch element, ``{out_prefix}_{i}.obj``; returns the
    paths."""
    from ..utils import save_obj

    verts, faces, mask = extract_predicted_surface(
        model, batch, statics, config, lattice_offsets=lattice_offsets,
        tet_lattice=tet_lattice, face_lattice=face_lattice)
    paths = []
    for i in range(verts.shape[0]):
        path = f"{out_prefix}_{i}.obj"
        save_obj(path, verts[i], faces[i][mask[i] > 0])
        paths.append(path)
    return paths


def make_inference_step(model, config: TrainConfig, lattice_offsets=None,
                        tet_lattice=None, face_lattice=None):
    """``infer(batch, statics, generator=None, draws=None)`` -> the
    inference metrics as (0-d) tensors: predicted occupancy, surface and
    all metrics, without gradients.

    ``draws`` may hold ``noise`` (the input noise), ``pred`` and ``gt``
    (each (face_id, u_raw, v) for ``sample_mesh_points``)."""
    if lattice_offsets is None or tet_lattice is None or face_lattice is None:
        raise NotImplementedError("only the regular-lattice grid is ported")

    @torch.no_grad()
    def infer(batch, statics: GridStatics,
              generator: torch.Generator | None = None,
              draws=None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        tet_pos, soa, logits = _predict(model, batch, statics, config,
                                        lattice_offsets, tet_lattice,
                                        noise=draws.get("noise"))
        prob = torch.sigmoid(logits)
        pred_occ = (prob > config.occ_threshold).float()
        work_faces, work_mask, mask_b, budget = _surface(
            pred_occ, statics, config, face_lattice)
        bsz = tet_pos.shape[0]
        bidx = torch.arange(bsz, device=tet_pos.device)[:, None, None]
        face_pos = tet_pos.float()[bidx, work_faces]  # (B, K, 3, 3)

        # occupancy IoU on the SDF sample points, each reading the
        # (first) tet that contains it; points outside the grid read 0
        gt_inside = (batch["sdf"] > 0).float()
        cond = points_in_tets_soa(soa, batch["sdf_points"])
        in_grid = (cond >= 0).float()
        pred_inside = paste_occupancy(pred_occ, cond) * in_grid
        occ_iou = torch.stack([iou(p, g, thresh=0.5)
                               for p, g in zip(pred_inside, gt_inside)])
        prob_at_pts = paste_occupancy(prob, cond) * in_grid
        sweep = {
            f"val_iou_{t:.1f}": torch.stack(
                [iou(p, g, thresh=t) for p, g in zip(prob_at_pts, gt_inside)]
            ).mean()
            for t in IOU_THRESHOLDS
        }
        val_iou_max = torch.stack(list(sweep.values())).max()

        # surface metrics on n_res points a side
        surface = batch["surface_points"]
        n_res = config.eval_points or config.num_sample_points
        gt_faces = batch["faces"].long()
        gt_face_mask = (torch.arange(gt_faces.shape[1],
                                     device=gt_faces.device)[None, :]
                        < batch["n_faces"][:, None]).float()
        pred_pts = sample_mesh_points(face_pos, work_mask, n_res, generator,
                                      draws.get("pred"))
        if n_res <= surface.shape[1]:
            gt_pts = surface[:, :n_res]
        else:
            # more than the stored samples: resample the GT mesh
            gt_tri = batch["verts"][bidx, gt_faces]
            gt_pts = sample_mesh_points(gt_tri, gt_face_mask, n_res,
                                        generator, draws.get("gt"))
        fs = f_score(gt_pts, pred_pts, radius=0.01)
        fs_ext = f_score(gt_pts, pred_pts, radius=0.01, extend=True)
        ch = chamfer_distance(pred_pts, gt_pts)
        ch_l1 = chamfer_distance_l1(pred_pts, gt_pts)

        # the predicted surface as an indexed soup of its face corners
        kf = face_pos.shape[1]
        pred_verts = face_pos.reshape(bsz, kf * 3, 3)
        pred_faces = torch.arange(kf * 3, device=face_pos.device).reshape(
            1, kf, 3).expand(bsz, -1, -1)
        haus_avg, haus_max = hausdorff_distance(
            pred_verts, pred_faces, work_mask, batch["verts"], gt_faces,
            gt_face_mask, pred_pts, gt_pts)

        n_boundary = mask_b.sum(dim=1)
        return {
            "occ_iou": occ_iou.mean(),
            "val_iou_max": val_iou_max,
            **sweep,
            "f_score": fs.mean(),
            "f_score_extend": fs_ext.mean(),
            "chamfer": ch.mean(),
            "chamfer_l1": ch_l1.mean(),
            "hausdorff": haus_avg.mean(),
            "hausdorff_max": haus_max.mean(),
            "n_boundary": n_boundary.mean(),
            # > 0: the budget cut the predicted surface to its first-k
            # (class-major) prefix
            "boundary_overflow": torch.clamp(n_boundary - budget,
                                             min=0.0).mean(),
        }

    return infer
