"""2D-supervision rendering stack (torch port of deftet_tpu/render; the
reference's diff_render/diftet_6_subdiv).

* camera    — pixel2mesh-style perspective transform, NeRF-Blender poses.
* raster    — the depth-peeled differentiable rasterizer: the hit pass
              (``raster_hit``, the hand-written CUDA kernel
              ``csrc/raster_hit.cu``, with its plain PyTorch version) and
              the differentiable replay.
* composite — alpha compositing over the peeled layers, white background.
* frame     — full frames over exact per-tile candidate lists.
* scene     — the optimizable tet scene: offsets, RGBA features, carving,
              subdivision, state files, surface export.
* optimize  — the staged carve/subdivide optimizer and its evaluation.
"""

from .camera import camera_from_blender, perspective, pose_spherical
from .composite import peel2mask, render_mesh_color
from .raster import deftet_sparse_render, raster_hit
from .scene import TetScene, build_render_faces

__all__ = [
    "TetScene",
    "build_render_faces",
    "camera_from_blender",
    "deftet_sparse_render",
    "peel2mask",
    "perspective",
    "pose_spherical",
    "raster_hit",
    "render_mesh_color",
]
