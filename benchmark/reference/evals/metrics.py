"""Evaluation metrics: IoU, F-score, Chamfer, Chamfer-L1 and Hausdorff
(torch port of deftet_tpu/evals/metrics.py).

The nearest-point searches run on K2 (``ops.nearest.
sided_squared_distance``) and the point-to-mesh searches on K3
(``ops.tri_distance.point_to_mesh_squared_distance``).
"""

from __future__ import annotations

import torch

from ..ops.nearest import sided_squared_distance
from ..ops.tri_distance import point_to_mesh_squared_distance

EPS = 1e-15


@torch.no_grad()
def iou_counts(pred: torch.Tensor, target: torch.Tensor,
               thresh: float = 0.5):
    """(intersection, union) sizes of the two sets binarized at
    ``thresh``."""
    p = (pred > thresh).to(torch.float32).reshape(-1)
    t = (target > thresh).to(torch.float32).reshape(-1)
    return torch.sum(p * t), torch.sum(torch.clamp(p + t, 0.0, 1.0))


@torch.no_grad()
def iou(pred: torch.Tensor, target: torch.Tensor,
        thresh: float = 0.5) -> torch.Tensor:
    """IoU of the two sets binarized at ``thresh`` (a scalar per call)."""
    inter, union = iou_counts(pred, target, thresh)
    return inter / torch.clamp(union, min=1.0)


@torch.no_grad()
def f_score(gt_points_bxnx3, pred_points_bxmx3, radius: float = 0.01,
            extend: bool = False):
    """F-score of hits within ``radius``, per batch element.  As in the
    original, ``pred_distances`` run from the GT points to the prediction
    and ``gt_distances`` the other way."""
    d_gt2pred, _ = sided_squared_distance(gt_points_bxnx3, pred_points_bxmx3)
    d_pred2gt, _ = sided_squared_distance(pred_points_bxmx3, gt_points_bxnx3)
    pred_distances = torch.sqrt(d_gt2pred + EPS)
    gt_distances = torch.sqrt(d_pred2gt + EPS)

    def count(x):
        return x.to(torch.float32).sum(dim=-1)

    fp = count(gt_distances > radius)
    tp = count(gt_distances <= radius)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    fn = count(pred_distances > radius)
    if extend:
        tp2 = count(pred_distances <= radius)
        recall = tp2 / torch.clamp(tp2 + fn, min=1.0)
    else:
        recall = tp / torch.clamp(tp + fn, min=1.0)
    return 2.0 * precision * recall / (precision + recall + 1e-8)


@torch.no_grad()
def chamfer_distance(s1_bxnx3, s2_bxmx3):
    """(mean sqrt d(s1 -> s2) + mean sqrt d(s2 -> s1)) / 2, per element."""
    d12, _ = sided_squared_distance(s1_bxnx3, s2_bxmx3)
    d21, _ = sided_squared_distance(s2_bxmx3, s1_bxnx3)
    return (torch.sqrt(d12 + EPS).mean(dim=-1)
            + torch.sqrt(d21 + EPS).mean(dim=-1)) / 2.0


@torch.no_grad()
def chamfer_distance_l1(s1_bxnx3, s2_bxmx3):
    """Sum over xyz of |p - nearest|, both directions added."""
    def one_way(a, b):
        _, idx = sided_squared_distance(a, b)
        closest = torch.gather(b, 1, idx.long()[..., None].expand(-1, -1, 3))
        return torch.abs(a - closest).sum(dim=-1).mean(dim=-1)

    return one_way(s1_bxnx3, s2_bxmx3) + one_way(s2_bxmx3, s1_bxnx3)


@torch.no_grad()
def hausdorff_distance(verts_a_bxnx3, faces_a_bxfx3, mask_a_bxf,
                       verts_b_bxmx3, faces_b_bxgx3, mask_b_bxg,
                       pts_a_bxpx3, pts_b_bxqx3):
    """Two-sided point-to-mesh Hausdorff: (avg, max) per batch element,
    each the mean of the two directions; masked faces are excluded."""
    bidx = torch.arange(verts_a_bxnx3.shape[0],
                        device=verts_a_bxnx3.device)[:, None, None]
    tri_a = verts_a_bxnx3[bidx, faces_a_bxfx3.long()]  # (B, F, 3, 3)
    tri_b = verts_b_bxmx3[bidx, faces_b_bxgx3.long()]
    d2_a, _ = point_to_mesh_squared_distance(pts_b_bxqx3, tri_a, mask_a_bxf)
    d2_b, _ = point_to_mesh_squared_distance(pts_a_bxpx3, tri_b, mask_b_bxg)
    da = torch.sqrt(d2_a + EPS)
    db = torch.sqrt(d2_b + EPS)
    avg = (da.mean(dim=-1) + db.mean(dim=-1)) / 2.0
    mx = (da.amax(dim=-1) + db.amax(dim=-1)) / 2.0
    return avg, mx
