"""Metrics."""

from .metrics import iou

__all__ = ["iou"]
