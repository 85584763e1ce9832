"""Metrics and the full-inference evaluation."""

from .harness import (
    decode_occ_full_grid,
    extract_predicted_surface,
    make_inference_step,
    sample_mesh_points,
    save_predicted_surface_objs,
)
from .metrics import (
    chamfer_distance,
    chamfer_distance_l1,
    f_score,
    hausdorff_distance,
    iou,
)

__all__ = [
    "chamfer_distance",
    "chamfer_distance_l1",
    "decode_occ_full_grid",
    "extract_predicted_surface",
    "f_score",
    "hausdorff_distance",
    "iou",
    "make_inference_step",
    "sample_mesh_points",
    "save_predicted_surface_objs",
]
