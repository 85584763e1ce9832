"""Frustum-PointNet box losses and the KL / huber extras (torch port of
deftet_tpu/losses/frustum.py): ``kl_loss``, ``huber_loss``,
``get_box_corners_3d`` and ``FrustumPointNetLoss``.

No path of either package calls these; they complete the inventory.
Plain tensor functions; the loss is a dataclass of weights applied to
dicts of tensors, channels-last (``mask_logits`` is (B, N, 2)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "kl_loss",
    "huber_loss",
    "get_box_corners_3d",
    "FrustumPointNetLoss",
]


def kl_loss(x_bxc: torch.Tensor, y_bxc: torch.Tensor) -> torch.Tensor:
    """KL(softmax(x) ‖ softmax(y)) over the last axis, mean over the
    batch; no gradient reaches ``x``, and an entry where softmax(x)
    underflows to 0 adds 0."""
    xs = x_bxc.detach()
    x = F.softmax(xs, dim=-1)
    logx = F.log_softmax(xs, dim=-1)
    logy = F.log_softmax(y_bxc, dim=-1)
    return torch.mean(torch.sum(torch.where(x > 0, x * (logx - logy), 0.0),
                                dim=-1))


def huber_loss(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean huber loss: quadratic up to ``delta``, linear past it."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    return torch.mean(0.5 * quadratic**2 + delta * (abs_error - quadratic))


def get_box_corners_3d(centers_nx3, headings_n, sizes_nx3, with_flip=False):
    """The 8 corners (N, 3, 8) of y-up boxes rotated by their heading
    about +y (and those of the heading + pi flip when asked)."""
    l, w, h = sizes_nx3[:, 0], sizes_nx3[:, 1], sizes_nx3[:, 2]
    half = torch.stack([
        torch.stack([l, l, -l, -l, l, l, -l, -l], dim=1),
        torch.stack([h, h, h, h, -h, -h, -h, -h], dim=1),
        torch.stack([w, -w, -w, w, w, -w, -w, w], dim=1),
    ], dim=1) / 2.0  # (N, 3, 8)
    c, s = torch.cos(headings_n), torch.sin(headings_n)
    z, o = torch.zeros_like(headings_n), torch.ones_like(headings_n)
    rot = torch.stack([c, z, s, z, o, z, -s, z, c], dim=1).reshape(-1, 3, 3)
    out = torch.einsum("nij,njk->nik", rot, half) + centers_nx3[:, :, None]
    if not with_flip:
        return out
    rot_f = torch.stack([-c, z, -s, z, o, z, s, z, -c],
                        dim=1).reshape(-1, 3, 3)
    flip = torch.einsum("nij,njk->nik", rot_f, half) + centers_nx3[:, :, None]
    return out, flip


def _cross_entropy(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, 1, labels.long()[:, None]))


@dataclass
class FrustumPointNetLoss:
    """Segmentation cross-entropy + the box's center, heading and size
    classification and residual regression + the corner consistency
    loss.  ``inputs`` / ``targets`` are dicts of tensors with the
    reference's keys."""

    num_heading_angle_bins: int
    num_size_templates: int
    size_templates: np.ndarray  # (NS, 3)
    box_loss_weight: float = 1.0
    corners_loss_weight: float = 10.0
    heading_residual_loss_weight: float = 20.0
    size_residual_loss_weight: float = 20.0
    heading_angle_bin_centers: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.size_templates = torch.as_tensor(
            np.asarray(self.size_templates, np.float32)).reshape(
                self.num_size_templates, 3)
        step = 2 * math.pi / self.num_heading_angle_bins
        self.heading_angle_bin_centers = torch.as_tensor(
            np.arange(self.num_heading_angle_bins, dtype=np.float32)
            * np.float32(step))

    def __call__(self, inputs: dict, targets: dict) -> torch.Tensor:
        dev = inputs["center"].device
        templates = self.size_templates.to(dev)
        bin_centers = self.heading_angle_bin_centers.to(dev)
        b = inputs["center"].shape[0]
        bid = torch.arange(b, device=dev)
        hbin = targets["heading_bin_id"].long()
        sbin = targets["size_template_id"].long()

        mask_loss = _cross_entropy(inputs["mask_logits"].reshape(-1, 2),
                                   targets["mask_logits"].reshape(-1))
        heading_loss = _cross_entropy(inputs["heading_scores"], hbin)
        size_loss = _cross_entropy(inputs["size_scores"], sbin)
        center_loss = huber_loss(torch.linalg.norm(
            targets["center"] - inputs["center"], dim=-1), delta=2.0)
        center_reg_loss = huber_loss(torch.linalg.norm(
            targets["center"] - inputs["center_reg"], dim=-1), delta=1.0)

        hres_norm = inputs["heading_residuals_normalized"][bid, hbin]
        hres_norm_target = targets["heading_residual"] / (
            np.pi / self.num_heading_angle_bins)
        heading_residual_loss = huber_loss(hres_norm - hres_norm_target,
                                           delta=1.0)
        sres_norm = inputs["size_residuals_normalized"][bid, sbin]
        sres_norm_target = targets["size_residual"] / templates[sbin]
        size_residual_loss = huber_loss(torch.linalg.norm(
            sres_norm_target - sres_norm, dim=-1), delta=1.0)

        heading = inputs["heading_residuals"][bid, hbin] + bin_centers[hbin]
        size = inputs["size_residuals"][bid, sbin] + templates[sbin]
        corners = get_box_corners_3d(inputs["center"], heading, size)
        heading_target = bin_centers[hbin] + targets["heading_residual"]
        size_target = templates[sbin] + targets["size_residual"]
        corners_target, corners_target_flip = get_box_corners_3d(
            targets["center"], heading_target, size_target, with_flip=True)
        corners_loss = huber_loss(torch.minimum(
            torch.linalg.norm(corners - corners_target, dim=1),
            torch.linalg.norm(corners - corners_target_flip, dim=1)),
            delta=1.0)

        return mask_loss + self.box_loss_weight * (
            center_loss + center_reg_loss + heading_loss + size_loss
            + self.heading_residual_loss_weight * heading_residual_loss
            + self.size_residual_loss_weight * size_residual_loss
            + self.corners_loss_weight * corners_loss)
