"""Camera transforms of the 2D-supervision renderer (torch port of
deftet_tpu/render/camera.py).

``perspective`` runs on tensors; ``pose_spherical`` and
``camera_from_blender`` are numpy copies (host-side camera set-up).
Pixel2mesh convention: p' = R^T (p - cam_pos); image xy = (p' * proj)_xy
/ (p' * proj)_z.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 on the card, whatever the global TF32
    setting: reduced precision here jitters camera-space coordinates by
    about a pixel once subdivided triangles shrink to one (the JAX
    package pins Precision.HIGHEST for this reason)."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def perspective(points_bxpx3, camera_rot_bx3x3, camera_pos_bx3,
                camera_proj_3):
    """World points -> (camera-space points (B, P, 3), image xy (B, P, 2)).

    ``camera_proj_3`` holds the per-axis projection scales (fx, fy, -1).
    """
    p = points_bxpx3 - camera_pos_bx3[:, None, :]
    p = _f32_matmul(p, camera_rot_bx3x3.transpose(1, 2))
    xyz = p * camera_proj_3.reshape(1, 1, 3)
    return p, xyz[..., :2] / xyz[..., 2:3]


def pose_spherical(theta_deg: float, phi_deg: float, radius: float):
    """(4, 4) numpy camera-to-world pose on a sphere (NeRF-Blender
    convention)."""
    def trans_t(t):
        m = np.eye(4)
        m[2, 3] = t
        return m

    def rot_phi(phi):
        m = np.eye(4)
        c, s = np.cos(phi), np.sin(phi)
        m[1, 1], m[1, 2] = c, -s
        m[2, 1], m[2, 2] = s, c
        return m

    def rot_theta(th):
        m = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        m[0, 0], m[0, 2] = c, s
        m[2, 0], m[2, 2] = -s, c
        return m

    c2w = trans_t(radius)
    c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]]) @ c2w


def camera_from_blender(c2w_4x4: np.ndarray, focal: float, h: int, w: int):
    """A NeRF-Blender camera-to-world matrix as the renderer's numpy
    (rot (1, 3, 3), pos (1, 3), proj (3,)) float32 triple.  The camera
    looks down -z (visible points have negative camera z, as the
    (-1000, 0) render range assumes); the proj z-slot is -1 so the divide
    lands in NDC with the right orientation."""
    c2w = np.asarray(c2w_4x4, dtype=np.float64)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3].T
    proj = np.array([2.0 * focal / w, 2.0 * focal / h, -1.0])
    return (rot.astype(np.float32)[None], pos.astype(np.float32)[None],
            proj.astype(np.float32))
