"""2D-supervision optimization pipeline (torch port of
deftet_tpu/render/optimize.py; the reference's
diff_render/diftet_6_subdiv/6_optim/optim_with_mask_subdiv_from_gridmov.py).

* per step: a random training view and a random pixel subset (whole
  16x16 screen tiles by default), render, and the loss
  L1(color) w_im + L1(mask) w_mask + mean(alpha) w_occ
  [+ mean|mov| w_pmov + sum(vol_var^2) w_tetvar when the grid moves]
  + dot(per-channel feature-Laplacian sums, weights_vector);
* two Adam groups (optax's arithmetic, b1 0.5): features at ``lr_feat``,
  grid motion at ``lr_mov``, both divided by sublevel + 1;
* carving every ``delete_every`` steps, with the candidate budget and peel
  depth recalibrated at every carve;
* per sublevel a {mov, fix} stage pair, then a budget-bounded 1->8
  subdivision; full-frame test PSNR after every stage.

The view, tile and pixel draws are numpy ``default_rng`` streams seeded
as in the JAX package, so both draw the same views and pixels.  The port
runs eagerly: a step renders at the current calibrated depth and budget
(the JAX package re-jits only when carving or the budget changes it), and
a multi-view evaluation renders and reads back one view at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..train.step import ClippedAdam
from .camera import camera_from_blender, perspective, pose_spherical
from .composite import peel2mask, vertex2face
from .raster import bin_overlap_max_np, deftet_sparse_render, hit_count_max
from .scene import TetScene, params_numpy

DEFAULT_WEIGHTS: Dict[str, object] = {
    "weights_im_loss": 1.0,
    "weights_mask_loss": 2.0,
    "weights_mask_reg": 0.01,
    "weights_point_mov": 0.01,
    "weights_tetvariance": 0.0,
    # per-channel feature-Laplacian weights [rgb = color_reg, alpha = occ_lap]
    "weights_vector": (0.0, 0.0, 0.0, 0.0),
    # with grid motion: + 3 mov channels at weights_point_mov
    "weights_vector_with_gridmov": (0.0, 0.0, 0.0, 0.0, 0.01, 0.01, 0.01),
}


def pixel_grid(height: int, width: int) -> np.ndarray:
    """(H*W, 2) NDC pixel centres, y up."""
    x = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    y = -((np.arange(height) + 0.5) / height * 2.0 - 1.0)
    ym, xm = np.meshgrid(y, x, indexing="ij")
    return np.stack([xm, ym], axis=2).reshape(-1, 2).astype(np.float32)


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------
def load_blender(basedir: str, half_res: bool = True,
                 splits=("train", "val", "test")):
    """NeRF-synthetic loader: (images (N, H, W, 4) in [0, 1], poses
    (N, 4, 4), (H, W, focal), split index lists)."""
    import imageio.v2 as imageio

    all_imgs, all_poses, counts = [], [], [0]
    meta = None
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            meta = json.load(f)
        imgs, poses = [], []
        for frame in meta["frames"]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imageio.imread(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(len(splits))]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    h, w = imgs.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    if half_res:
        imgs = imgs[:, ::2, ::2]
        h, w, focal = h // 2, w // 2, focal / 2.0
    return imgs, poses, (h, w, focal), i_split


@torch.no_grad()
def _render_mesh_views(verts, faces, feat_logits, poses, focal, height,
                       width, k, device, pix_chunk=None):
    """Ground truth: (N, H, W, 4) [rgb, mask] renders of a coloured mesh."""
    dev = torch.device(device)
    verts_t = torch.as_tensor(verts, device=dev)
    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.long,
                              device=dev)
    face_feat = vertex2face(torch.sigmoid(torch.as_tensor(
        feat_logits, device=dev))[None], faces_t)
    grid = torch.as_tensor(pixel_grid(height, width), device=dev)
    n_pix = grid.shape[0]
    pix_chunk = pix_chunk or n_pix
    images = []
    for c2w in poses:
        rot, pos, proj = (torch.as_tensor(x, device=dev) for x in
                          camera_from_blender(c2w, focal, height, width))
        cam, xy = perspective(verts_t[None], rot, pos, proj)
        face_z = vertex2face(cam[..., 2:3], faces_t)[..., 0]
        face_img = vertex2face(xy, faces_t)
        parts = []
        for s in range(0, n_pix, pix_chunk):
            pix = grid[s:s + pix_chunk][None]
            rng = torch.cat([torch.full_like(pix[..., :1], -1000.0),
                             torch.zeros_like(pix[..., :1])], dim=-1)
            layers, _ = deftet_sparse_render(pix, rng, face_z, face_img,
                                             face_feat, k=k)
            color, vis, _ = peel2mask(layers)
            parts.append(torch.cat([color, vis], dim=-1)[0])
        images.append(torch.cat(parts).reshape(height, width, 4).cpu()
                      .numpy())
    return np.stack(images).astype(np.float32)


def make_synthetic_scene(n_views: int = 8, height: int = 64, width: int = 64,
                         radius: float = 3.5, seed: int = 0,
                         coef: float = 2.5, device="cuda"):
    """Procedural ground truth: a coloured blob rendered through this
    renderer.  Returns the ``load_blender`` interface; every 4th view is a
    test view, views 2 mod 8 are the validation views."""
    from ..data.shapes import random_shape

    verts, faces = random_shape(seed, level=2)
    verts = (verts * coef).astype(np.float32)
    color_logits = np.tanh(verts * 3.0) * 3.0
    focal = 0.5 * width / np.tan(0.5 * 0.69)
    feat = np.concatenate(
        [np.full((verts.shape[0], 1), 8.0, np.float32), color_logits], axis=1)
    poses = np.stack([pose_spherical(360.0 * i / n_views, -30.0, radius)
                      for i in range(n_views)]).astype(np.float32)
    images = _render_mesh_views(verts, faces, feat, poses, focal, height,
                                width, 4, device)
    idx = np.arange(n_views)
    if n_views >= 4:
        i_test = idx[::4]
        i_val = idx[2::8]
        i_train = np.setdiff1d(idx, np.concatenate([i_test, i_val]))
    else:
        i_train, i_test = idx[: max(1, n_views - 1)], idx[-1:]
        i_val = i_test
    return images, poses, (height, width, focal), [i_train, i_val, i_test]


def protocol_scene_mesh(seed: int = 0, n_shapes: int = 3, coef: float = 2.5,
                        half_extent: Optional[float] = None):
    """The mesh behind ``make_nerf_protocol_scene``: (verts (V, 3) world
    scale, faces (F, 3) int32, feat_logits (V, 4) [alpha, rgb]).  A union
    of ``n_shapes`` random closed meshes fitted into the grid's world box
    (``half_extent``; default 0.95 coef, the Kuhn lattice's)."""
    from ..data.shapes import random_shape

    rng = np.random.default_rng(seed)
    verts_list, faces_list, offset = [], [], 0
    for s in range(n_shapes):
        v, f = random_shape(seed * 31 + s, level=3)
        scale = 0.45 + 0.25 * rng.random()
        center = rng.uniform(-0.45, 0.45, size=3)
        center[2] = abs(center[2]) * 0.5
        v = v * scale + center
        verts_list.append(v)
        faces_list.append(np.asarray(f) + offset)
        offset += v.shape[0]
    verts = np.concatenate(verts_list).astype(np.float32)
    verts -= (verts.max(0) + verts.min(0)) / 2.0
    verts *= 0.95 / np.abs(verts).max()
    faces = np.concatenate(faces_list).astype(np.int32)
    scale = coef if half_extent is None else half_extent / 0.95
    verts = (verts * scale).astype(np.float32)
    phase = np.concatenate(
        [np.full((v.shape[0], 3), rng.uniform(-1.5, 1.5, 3), np.float32)
         for v in verts_list])
    color_logits = np.tanh(np.sin(verts * 2.5 + phase) * 2.0) * 3.0
    feat = np.concatenate(
        [np.full((verts.shape[0], 1), 8.0, np.float32), color_logits], axis=1)
    return verts, faces, feat


def make_nerf_protocol_scene(
    n_train: int = 100,
    n_test_pool: int = 200,
    testskip: int = 8,
    n_val: int = 8,
    height: int = 400,
    width: int = 400,
    radius: float = 4.0,
    seed: int = 0,
    coef: float = 2.5,
    camera_angle_x: float = 0.6911112,
    elevation_range: Tuple[float, float] = (-80.0, -5.0),
    pix_chunk: int = 20000,
    n_shapes: int = 3,
    gt_k: int = 16,
    half_extent: Optional[float] = None,
    device="cuda",
):
    """Procedural ground truth at the NeRF-synthetic capture protocol:
    400x400 frames, camera_angle_x focal, spherical poses of random
    azimuth and elevation, 100 train and 8 val views and a 200-pose test
    pool taken every ``testskip``, rendered at peel depth ``gt_k``.
    Returns the ``load_blender`` interface."""
    verts, faces, feat = protocol_scene_mesh(seed, n_shapes, coef,
                                             half_extent)
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)
    # the pose stream continues after the mesh builder's draws
    rng = np.random.default_rng(seed)
    for _ in range(n_shapes):
        rng.random()
        rng.uniform(-0.45, 0.45, size=3)
    for _ in range(n_shapes):
        rng.uniform(-1.5, 1.5, 3)

    def draw_poses(n):
        thetas = rng.uniform(-180.0, 180.0, size=n)
        phis = rng.uniform(elevation_range[0], elevation_range[1], size=n)
        return [pose_spherical(t, p, radius) for t, p in zip(thetas, phis)]

    train_poses = draw_poses(n_train)
    val_poses = draw_poses(n_val)
    test_poses = draw_poses(n_test_pool)[::testskip]
    poses = np.stack(train_poses + val_poses + test_poses).astype(np.float32)
    splits = [np.arange(n_train), np.arange(n_train, n_train + n_val),
              np.arange(n_train + n_val, poses.shape[0])]
    images = _render_mesh_views(verts, faces, feat, poses, focal, height,
                                width, gt_k, device, pix_chunk)
    return images, poses, (height, width, focal), splits


# --------------------------------------------------------------------------
# Optimization
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RenderOptConfig:
    """Defaults of the reference's 6_optim/expconfig.py (see the JAX
    package's RenderOptConfig for each field's reasoning)."""

    tet_res: int = 40
    tet_file: Optional[str] = None  # quartet .tet grid; overrides tet_res
    coef: float = 2.5
    sublevels: int = 2
    steps_fix: int = 3000
    steps_mov: int = 2000
    pixel_sampling: float = 0.04
    lr_feat: float = 5e-2
    lr_mov: float = 5e-4
    delete_every: int = 1000
    delete_threshold: float = 1e-3
    carve_dilation: int = 3
    subdiv_threshold: Optional[float] = None
    k: int = 300                  # peel depth (kaolin's knum)
    raster_chunk: int = 1024      # the plain hit scan's candidate chunk
    bin_cand: int = -1            # -1 calibrated, 0 off
    bin_pixel_chunk: int = 512    # pixels per strip tile (iid sampling)
    tile_sampling: int = 16       # train on whole WxW screen tiles (0 = iid)
    frame_tile: int = 16          # full-frame tile width
    tet_budget: int = 1_000_000   # post-subdivision tets (0 = unlimited)
    presubdiv_psnr_drop: float = 0.3
    seed: int = 0


def _white_composite(images_nxhxwx4: np.ndarray):
    rgb = images_nxhxwx4[..., :3]
    mask = images_nxhxwx4[..., 3:4]
    return rgb * mask + (1.0 - mask), mask


def project_faces_np(scene: TetScene, params, cam) -> np.ndarray:
    """Host-side (F, 3, 2) screen-space faces for one camera (numpy twin
    of ``perspective``), for the binning oracles and the frame lists."""
    pts = scene.coef * (scene.points_px3 + params_numpy(params)["mov"])
    rot, pos, proj = (np.asarray(x) for x in cam)
    p = (pts - pos[0]) @ rot[0].T
    xyz = p * proj.reshape(1, 3)
    return (xyz[:, :2] / xyz[:, 2:3])[scene.faces_fx3]


def _tile_mode(cfg: RenderOptConfig, h: int, w: int, n_pix: int):
    """(tile_width, n_tiles) when tile sampling applies, else (0, 0)."""
    t = cfg.tile_sampling
    if t and h % t == 0 and w % t == 0 and n_pix >= t * t:
        return t, max(1, n_pix // (t * t))
    return 0, 0


def _pow2ceil(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def calibrate_bin_cand(scene: TetScene, params, cams, views,
                       grid: np.ndarray, n_pix: int, cfg: RenderOptConfig,
                       margin: float = 1.5,
                       hw: Optional[Tuple[int, int]] = None) -> int:
    """Candidate budget for binned training renders: margin x the worst
    per-tile bbox overlap of training-like pixel samples through a few
    cameras, rounded up (512, or 4096 above 8k; at least 2048); 0 (off)
    when culling cannot win.  Draws from its own seed-derived stream."""
    f = int(scene.faces_fx3.shape[0])
    if cfg.bin_cand == 0 or f <= 4096:
        return 0
    if cfg.bin_cand > 0:
        return cfg.bin_cand
    rng = np.random.default_rng(cfg.seed ^ 0x5EEDCA1B)
    t, n_tiles = _tile_mode(cfg, *(hw or (0, 1)), n_pix)
    if t:
        from .frame import tile_pixel_layout

        layout, _ = tile_pixel_layout(hw[0], hw[1], t)
    worst = 0
    for v in views:
        face_img = project_faces_np(scene, params, cams[int(v)])
        if t:
            tiles = rng.choice(layout.shape[0], size=n_tiles, replace=False)
            worst = max(worst, bin_overlap_max_np(
                face_img, grid[layout[tiles].reshape(-1)], t * t,
                sort=False))
        else:
            pick = rng.choice(grid.shape[0], size=min(n_pix, grid.shape[0]),
                              replace=False)
            worst = max(worst, bin_overlap_max_np(face_img, grid[pick],
                                                  cfg.bin_pixel_chunk))
    quantum = 4096 if worst * margin > 8192 else 512
    cand = max(-(-int(worst * margin) // quantum) * quantum, 2048)
    return 0 if cand >= f else cand


def calibrate_peel_k(scene: TetScene, params, cams, views, grid: np.ndarray,
                     n_pix: int, cfg: RenderOptConfig, margin: float = 1.25,
                     hw: Optional[Tuple[int, int]] = None,
                     raw: bool = False) -> int:
    """Peel depth for training renders: the true max per-pixel coverage
    over training-like samples through a few cameras (the hit pass's
    exact count, every face), times ``margin``, pow2-rounded, capped at
    ``cfg.k`` (``raw``: the coverage itself)."""
    if cfg.k <= 8:
        return cfg.k
    rng = np.random.default_rng(cfg.seed ^ 0x9E37A1)
    t, n_tiles = _tile_mode(cfg, *(hw or (0, 1)), n_pix)
    if t:
        from .frame import tile_pixel_layout

        layout, _ = tile_pixel_layout(hw[0], hw[1], t)
    worst = 0
    with torch.no_grad():
        for v in views:
            face_z, face_img, _ = scene.face_arrays(params, *cams[int(v)])
            if t:
                tiles = rng.choice(layout.shape[0], size=n_tiles,
                                   replace=False)
                pick = layout[tiles].reshape(-1)
            else:
                pick = rng.choice(grid.shape[0],
                                  size=min(n_pix, grid.shape[0]),
                                  replace=False)
            pix = grid[pick]
            pixrange = np.concatenate(
                [pix, np.full((pix.shape[0], 1), -1000.0, np.float32),
                 np.zeros((pix.shape[0], 1), np.float32)], axis=1)
            worst = max(worst, hit_count_max(
                torch.as_tensor(pixrange, device=scene.device), face_z,
                face_img))
    if raw:
        return worst
    return min(cfg.k, max(8, _pow2ceil(int(worst * margin))))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0, as JAX differentiates abs (torch's is
    0 there; at the zero initial offsets that decides every first mov
    update)."""
    return torch.where(x >= 0, x, -x)


def make_render_step(scene: TetScene, weights: Dict[str, object],
                     gridmov: bool, cfg: RenderOptConfig,
                     opt_feat: ClippedAdam, opt_mov: ClippedAdam,
                     pixel_chunk: Optional[int] = None,
                     bin_sort: bool = True):
    """One optimization step on the current topology:
    ``step(params, pix, rot, pos, proj, gt_color, gt_mask) -> aux``.
    The optimizers update ``params["feat"]`` (and ``params["mov"]`` when
    the grid moves) in place; ``aux`` holds the loss terms and the total.
    ``pixel_chunk`` / ``bin_sort`` set the raster's tiles (tile-sampled
    training passes its tile size, unsorted)."""
    from ..losses.geometry import volume_variance

    w_vec = torch.tensor(weights["weights_vector_with_gridmov" if gridmov
                                 else "weights_vector"],
                         dtype=torch.float32, device=scene.device)
    pixel_chunk = pixel_chunk or cfg.bin_pixel_chunk

    def loss_fn(params, pix, rot, pos, proj, gt_color, gt_mask):
        color, mask = scene.render(
            params, pix, rot, pos, proj, k=cfg.k, chunk=cfg.raster_chunk,
            pixel_chunk=pixel_chunk, bin_cand=cfg.bin_cand,
            bin_sort=bin_sort)[:2]
        loss_im = torch.mean(_abs(color - gt_color))
        loss_mask = torch.mean(_abs(mask - gt_mask))
        feat = torch.sigmoid(params["feat"])
        alpha, rgb = feat[:, :1], feat[:, 1:]
        loss_occ = torch.mean(alpha)
        total = (loss_im * weights["weights_im_loss"]
                 + loss_mask * weights["weights_mask_loss"]
                 + loss_occ * weights["weights_mask_reg"])
        lap_inputs = [rgb, alpha]
        if gridmov:
            loss_mov = torch.mean(_abs(params["mov"]))
            tet_pos = scene.world_points(params)[None][
                :, scene.tensor("tets_tx4")]
            var = volume_variance(tet_pos, pow=2)
            total = (total + weights["weights_point_mov"] * loss_mov
                     + weights["weights_tetvariance"] * torch.sum(var**2))
            lap_inputs.append(params["mov"])
        lap = scene.feature_laplacian(torch.cat(lap_inputs, dim=-1))
        total = total + torch.dot(torch.sum(lap, dim=0), w_vec)
        return total, {"loss_im": loss_im, "loss_mask": loss_mask,
                       "loss_occ": loss_occ}

    def step(params, pix, rot, pos, proj, gt_color, gt_mask):
        leaves = [params["feat"]] + ([params["mov"]] if gridmov else [])
        for t in leaves:
            t.requires_grad_(True)
        live = {"feat": params["feat"],
                "mov": params["mov"] if gridmov else params["mov"].detach()}
        total, aux = loss_fn(live, pix, rot, pos, proj, gt_color, gt_mask)
        grads = torch.autograd.grad(total, leaves)
        opt_feat.step([grads[0]])
        if gridmov:
            opt_mov.step([grads[1]])
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total"] = total.detach()
        return aux

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def optimize_stage(
    scene: TetScene,
    params: Dict[str, torch.Tensor],
    images: np.ndarray,
    poses: np.ndarray,
    hwf: Tuple[int, int, float],
    i_train: np.ndarray,
    cfg: RenderOptConfig,
    gridmov: bool,
    steps: int,
    weights: Optional[Dict[str, object]] = None,
    log_every: int = 200,
    log: Optional[Callable[[str], None]] = print,
    lr_div: float = 1.0,
    deadline: Optional[float] = None,
    video_path: Optional[str] = None,
    video_every: int = 200,
    cal_margin: float = 1.5,
    step_log: Optional[list] = None,
):
    """One {mov | fix} stage.  Returns (params, history, info): the total
    loss per step, and the binning audit (calibrated budget and peel depth,
    and their end-of-stage overflow re-measured on the final parameters;
    non-zero means late renders were approximate).

    ``lr_div`` divides both learning rates (the reference's per-sublevel
    decay); ``deadline`` (a ``time.monotonic()`` time) ends the stage
    early; ``video_path`` writes a convergence video of the first train
    view every ``video_every`` steps.  ``step_log``, when given, receives
    one dict per step: its seconds (the device synchronised) and whether
    it carved and recalibrated first."""
    weights = weights or DEFAULT_WEIGHTS
    h, w, focal = hwf
    gt_color, gt_mask = _white_composite(images)
    grid = pixel_grid(h, w)
    rng = np.random.default_rng(cfg.seed + (1 if gridmov else 0))
    cams = [camera_from_blender(poses[i], focal, h, w)
            for i in range(len(poses))]
    dev = scene.device

    opt_feat = ClippedAdam([params["feat"]], cfg.lr_feat / lr_div, None,
                           b1=0.5, b2=0.999)
    opt_mov = ClippedAdam([params["mov"]], cfg.lr_mov / lr_div, None,
                          b1=0.5, b2=0.999)

    n_pix = max(1, int(cfg.pixel_sampling * h * w))
    tile_w, n_tiles = _tile_mode(cfg, h, w, n_pix)
    if tile_w:
        from .frame import tile_pixel_layout

        tile_layout, _ = tile_pixel_layout(h, w, tile_w)
        if log:
            log(f"[tiles] sampling {n_tiles} {tile_w}x{tile_w} blocks "
                f"per step ({n_tiles * tile_w * tile_w} px)")

    def _calibrated_cfg():
        cand = calibrate_bin_cand(scene, params, cams, i_train[:3], grid,
                                  n_pix, cfg, margin=cal_margin, hw=(h, w))
        k_cal = calibrate_peel_k(scene, params, cams, i_train[:2], grid,
                                 n_pix, cfg,
                                 margin=max(1.25, cal_margin - 0.25),
                                 hw=(h, w))
        if log and (cand != cfg.bin_cand or k_cal != cfg.k):
            log(f"[bin] candidate budget {cand or 'off'}, peel k {k_cal} "
                f"(faces {scene.faces_fx3.shape[0]})")
        return dataclasses.replace(cfg, bin_cand=cand, k=k_cal)

    step_kw = dict(pixel_chunk=(tile_w * tile_w if tile_w else None),
                   bin_sort=not tile_w)

    def _step_fn(c):
        return make_render_step(scene, weights, gridmov, c, opt_feat,
                                opt_mov, **step_kw)

    cal_cfg = _calibrated_cfg()
    step_fn = _step_fn(cal_cfg)
    history = []
    video_frames = []

    def _snap():
        color, _ = render_full_image(scene, params, poses[int(i_train[0])],
                                     hwf, cfg)
        video_frames.append((np.clip(color, 0.0, 1.0) * 255).astype(np.uint8))

    for i in range(steps):
        if deadline is not None and time.monotonic() > deadline:
            if log:
                log(f"[{'mov' if gridmov else 'fix'}] deadline hit at step "
                    f"{i}/{steps}; ending stage early")
            break
        t0 = time.perf_counter()
        recal = (i > 0 and i % cfg.delete_every == cfg.delete_every - 1
                 and i < steps - 1)
        if recal:
            # vertices drift, so the budget and depth are re-measured at
            # every carve boundary, carved or not
            scene.carve(params, cfg.delete_threshold,
                        neighbor_levels=cfg.carve_dilation)
            cal_cfg = _calibrated_cfg()
            step_fn = _step_fn(cal_cfg)
        view = int(i_train[rng.integers(len(i_train))])
        if tile_w:
            tiles = rng.choice(tile_layout.shape[0], size=n_tiles,
                               replace=False)
            pick = tile_layout[tiles].reshape(-1)
        else:
            pick = rng.choice(h * w, size=n_pix, replace=False)
        pix = torch.as_tensor(grid[pick], device=dev)[None]
        gc = torch.as_tensor(gt_color[view].reshape(-1, 3)[pick],
                             device=dev)[None]
        gm = torch.as_tensor(gt_mask[view].reshape(-1, 1)[pick],
                             device=dev)[None]
        aux = step_fn(params, pix, *cams[view], gc, gm)
        if log and (i % log_every == 0):
            log(f"[{'mov' if gridmov else 'fix'} {i}/{steps}] "
                f"total={float(aux['total']):.4f} "
                f"im={float(aux['loss_im']):.4f} "
                f"mask={float(aux['loss_mask']):.4f}")
        history.append(float(aux["total"]))
        if step_log is not None:
            _sync(dev)
            step_log.append({"step": i, "recalibrated": bool(recal),
                             "seconds": time.perf_counter() - t0})
        if video_path and (i % video_every == 0):
            _snap()
    if video_path:
        _snap()
        write_video(video_frames, video_path, fps=8, log=log)
    overflow_final = 0
    peel_overflow_final = 0
    if cal_cfg.k < cfg.k and gridmov:
        # the calibrated depth against the final parameters
        worst_k = calibrate_peel_k(scene, params, cams, i_train[:2], grid,
                                   n_pix, cfg, hw=(h, w), raw=True)
        peel_overflow_final = max(worst_k - cal_cfg.k, 0)
        if peel_overflow_final and log:
            log(f"[peel] WARNING: end-of-stage coverage {worst_k} exceeds "
                f"the calibrated peel depth {cal_cfg.k}")
    if cal_cfg.bin_cand and gridmov:
        # the calibrated budget against the final parameters (fix stages
        # move no vertex, so theirs stays exact)
        def _probe_pick():
            if tile_w:
                tiles = rng.choice(tile_layout.shape[0], size=n_tiles,
                                   replace=False)
                return tile_layout[tiles].reshape(-1)
            return rng.choice(h * w, size=n_pix, replace=False)

        worst = max(
            bin_overlap_max_np(
                project_faces_np(scene, params, cams[int(v)]),
                grid[_probe_pick()],
                tile_w * tile_w if tile_w else cfg.bin_pixel_chunk,
                sort=not tile_w)
            for v in i_train[:2])
        overflow_final = max(worst - cal_cfg.bin_cand, 0)
        if overflow_final and log:
            log(f"[bin] WARNING: end-of-stage overlap {worst} exceeds the "
                f"calibrated budget {cal_cfg.bin_cand}; late-stage "
                f"training renders were approximate")
    info = {
        "bin_cand": int(cal_cfg.bin_cand),
        "bin_overflow_final": int(overflow_final),
        "cal_margin": float(cal_margin),
        "peel_k": int(cal_cfg.k),
        "peel_overflow_final": int(peel_overflow_final),
    }
    return params, history, info


# --------------------------------------------------------------------------
# Evaluation and export
# --------------------------------------------------------------------------
@torch.no_grad()
def render_full_image(scene: TetScene, params, pose_4x4: np.ndarray, hwf,
                      cfg: RenderOptConfig):
    """Full frame: (color (H, W, 3), vis (H, W, 1)) numpy, over exact
    per-tile candidate lists at any face count (render/frame.py).  The
    frame is rendered and read back here (the JAX package's
    dispatch_full_image queues it for a later resolve)."""
    from .frame import render_frame

    h, w, focal = hwf
    cam = camera_from_blender(pose_4x4, focal, h, w)
    face_z, face_img, face_feat = scene.face_arrays(params, *cam)
    return render_frame(
        face_z, face_img, face_feat, project_faces_np(scene, params, cam),
        h, w, k=cfg.k, chunk=cfg.raster_chunk, tile=cfg.frame_tile)[:2]


def evaluate_psnr(scene: TetScene, params, images, poses, hwf, i_test,
                  cfg: RenderOptConfig):
    """Mean test MSE and PSNR over full frames, one view at a time."""
    gt_color, _ = _white_composite(images)
    mses = [float(np.mean((render_full_image(scene, params, poses[i], hwf,
                                             cfg)[0] - gt_color[i]) ** 2))
            for i in i_test]
    mse = float(np.mean(mses))
    return mse, float(-10.0 * np.log10(max(mse, 1e-10)))


def write_video(frames_u8, path: str, fps: int = 8,
                log: Optional[Callable[[str], None]] = print) -> str:
    """Write frames to ``path``: mp4 (OpenCV mp4v) or GIF (imageio) by
    extension, an mp4 falling back to GIF without OpenCV.  Without
    imageio, the uint8 frames go to an ``.npz`` beside ``path`` instead.
    Returns the path written."""
    frames_u8 = [np.ascontiguousarray(f) for f in frames_u8]
    if path.endswith(".mp4"):
        try:
            import cv2

            h, w = frames_u8[0].shape[:2]
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
            if vw.isOpened():
                for f in frames_u8:
                    vw.write(f[..., ::-1])  # RGB -> BGR
                vw.release()
                return path
        except ImportError:
            pass
        path = path[:-4] + ".gif"
    try:
        import imageio.v2 as imageio
    except ImportError:
        path = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(path, frames=np.stack(frames_u8))
        if log:
            log(f"[video] no imageio: frames written to {path}")
        return path
    imageio.mimwrite(path, list(frames_u8), fps=fps)
    return path


def export_turntable(scene: TetScene, params, hwf, cfg: RenderOptConfig,
                     path: str, n_frames: int = 24, radius: float = 3.5,
                     phi: float = -30.0, fps: int = 8,
                     log: Optional[Callable[[str], None]] = print):
    """Render a circular camera path and write it as a video (see
    ``write_video``).  Returns the frames (N, H, W, 3) uint8."""
    frames = np.stack([
        (np.clip(render_full_image(
            scene, params, pose_spherical(360.0 * i / n_frames, phi, radius),
            hwf, cfg)[0], 0.0, 1.0) * 255).astype(np.uint8)
        for i in range(n_frames)])
    write_video(frames, path, fps=fps, log=log)
    return frames


def carve_and_subdivide(scene: TetScene, params, images, poses, hwf, i_quick,
                        cfg: RenderOptConfig,
                        log: Optional[Callable[[str], None]] = print):
    """Budget-bounded sublevel transition: carve, then 1->8 subdivide.

    The reference's semantics (carve at ``delete_threshold``, split every
    alive tet) when the result fits ``cfg.tet_budget``; otherwise, in
    order of rising quality risk: harder carves (20x / 50x / 100x the
    threshold, dilation 1) accepted while the quick PSNR on ``i_quick``
    drops at most ``presubdiv_psnr_drop``; a split of the surface band
    only (tets with min corner alpha < 0.9); no split.  Returns the
    (possibly new) parameters; mutates ``scene``."""
    log = log or (lambda m: None)
    scene.carve(params, cfg.delete_threshold,
                neighbor_levels=cfg.carve_dilation)
    budget = cfg.tet_budget
    if not budget or scene.n_tets * 8 <= budget:
        log(f"[subdiv] splitting all {scene.n_tets} tets 1->8")
        return scene.subdivide(params, cfg.subdiv_threshold)

    log(f"[subdiv] {scene.n_tets} alive tets would exceed the {budget} "
        f"post-subdivision budget; escalating carve")

    def quick_psnr():
        return evaluate_psnr(scene, params, images, poses, hwf, i_quick,
                             cfg)[1]

    base_psnr = quick_psnr()
    tets_ref = scene.tets_tx4.copy()

    def restore():
        scene.tets_tx4 = tets_ref.copy()
        scene.refresh_topology()

    for mult in (20.0, 50.0, 100.0):
        thr = cfg.delete_threshold * mult
        restore()
        scene.carve(params, thr, neighbor_levels=1)
        if scene.n_tets * 8 > budget:
            log(f"[subdiv] carve thr={thr}: {scene.n_tets} tets, still over "
                f"budget")
            continue
        psnr = quick_psnr()
        log(f"[subdiv] carve thr={thr}: {scene.n_tets} tets, quick PSNR "
            f"{psnr:.2f} (base {base_psnr:.2f})")
        if base_psnr - psnr <= cfg.presubdiv_psnr_drop:
            return scene.subdivide(params, cfg.subdiv_threshold)
        break  # harder carving only loses more quality

    restore()
    alpha = 1.0 / (1.0 + np.exp(-params_numpy(params)["feat"][:, 0]))
    flagged = int((alpha[scene.tets_tx4].min(axis=1) < 0.9).sum())
    est = 8 * flagged + (scene.n_tets - flagged)
    if est <= budget:
        log(f"[subdiv] selective surface-band split: {flagged} of "
            f"{scene.n_tets} tets -> ~{est}")
        return scene.subdivide(params, 0.9)
    log(f"[subdiv] even selective split (~{est}) exceeds the budget; "
        f"keeping the current level ({scene.n_tets} tets)")
    return params


def run_pipeline(images: np.ndarray, poses: np.ndarray, hwf, i_split,
                 cfg: Optional[RenderOptConfig] = None,
                 weights: Optional[Dict[str, object]] = None,
                 log: Optional[Callable[[str], None]] = print,
                 device="cuda", step_log: Optional[list] = None):
    """The staged schedule: per sublevel a {mov, fix} stage pair with a
    test-PSNR record after each, then ``carve_and_subdivide``.  Returns
    (scene, params, records).  ``step_log``, when given, receives one
    dict per stage: its steps (see ``optimize_stage``) and the seconds
    of its PSNR evaluation."""
    from ..tetgrid import build_tet_grid, read_tet_file

    cfg = cfg or RenderOptConfig()
    i_train, i_val, i_test = i_split
    grid = (read_tet_file(cfg.tet_file) if cfg.tet_file
            else build_tet_grid(cfg.tet_res))
    scene = TetScene.from_grid(grid, coef=cfg.coef, device=device)
    params = scene.init_params()
    records: List[Dict] = []

    cal_margin = 1.5
    for sub in range(cfg.sublevels + 1):
        for gridmov, steps in ((True, cfg.steps_mov), (False, cfg.steps_fix)):
            if steps <= 0:
                continue
            stage = "mov" if gridmov else "fix"
            steps_log = [] if step_log is not None else None
            params, _, stage_info = optimize_stage(
                scene, params, images, poses, hwf, i_train, cfg,
                gridmov=gridmov, steps=steps, weights=weights, log=log,
                lr_div=float(sub + 1), cal_margin=cal_margin,
                step_log=steps_log)
            if (stage_info["bin_overflow_final"]
                    or stage_info["peel_overflow_final"]):
                cal_margin *= 2.0  # drift beat the margin once
            t0 = time.perf_counter()
            mse, psnr = evaluate_psnr(scene, params, images, poses, hwf,
                                      i_test, cfg)
            if step_log is not None:
                step_log.append({"sublevel": sub, "stage": stage,
                                 "steps": steps_log,
                                 "psnr_seconds": time.perf_counter() - t0,
                                 "psnr_views": len(i_test)})
            records.append({"sublevel": sub, "stage": stage, "mse": mse,
                            "psnr": psnr, "n_tets": scene.n_tets,
                            **stage_info})
            if log:
                log(f"[sub {sub} {stage}] mse={mse:.5f} psnr={psnr:.2f} "
                    f"tets={scene.n_tets}")
        if sub < cfg.sublevels:
            params = carve_and_subdivide(scene, params, images, poses, hwf,
                                         i_val[:4], cfg, log=log)
    return scene, params, records
