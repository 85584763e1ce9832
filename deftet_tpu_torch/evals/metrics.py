"""Evaluation metrics used by the train step (torch port of
deftet_tpu/evals/metrics.py:iou)."""

from __future__ import annotations

import torch


@torch.no_grad()
def iou(pred: torch.Tensor, target: torch.Tensor,
        thresh: float = 0.5) -> torch.Tensor:
    """IoU of the two sets binarized at ``thresh`` (a scalar per call)."""
    p = (pred > thresh).to(torch.float32).reshape(-1)
    t = (target > thresh).to(torch.float32).reshape(-1)
    inter = torch.sum(p * t)
    union = torch.sum(torch.clamp(p + t, 0.0, 1.0))
    return inter / torch.clamp(union, min=1.0)
