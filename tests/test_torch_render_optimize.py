"""The port's 2D-supervision optimizer (deftet_tpu_torch.render.optimize)
against the JAX package's, on the CPU, at grids of res 3-8 and images of
16-32 pixels.

Tolerances: ground-truth images rtol 1e-5; calibrations equal integers;
one step's loss terms rtol 1e-5, gradients rtol 1e-4 (atol a
hundred-thousandth of the largest) and parameters after Adam rtol 1e-5
(atol 1e-5 lr);
a stage's loss history rtol 1e-4; a pipeline's records within 1e-3 dB of
PSNR.  Views, tiles and pixels come from the same numpy streams in both.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deftet_tpu.render import optimize as jopt
from deftet_tpu.render.scene import TetScene as JScene
from deftet_tpu.tetgrid import build_tet_grid as j_build_grid
from deftet_tpu_torch import cli
from deftet_tpu_torch.render import optimize as topt
from deftet_tpu_torch.render.scene import TetScene
from deftet_tpu_torch.tetgrid import build_tet_grid
from deftet_tpu_torch.train.step import ClippedAdam


@pytest.fixture(scope="module")
def scene_data():
    return topt.make_synthetic_scene(n_views=4, height=32, width=32,
                                     device="cpu")


def _scenes(res, seed=0, empty_half=False):
    """(port scene, params, JAX scene, params) on a res grid, random
    parameters; ``empty_half`` makes alpha ~0 where x < 0 (carvable)."""
    rng = np.random.default_rng(seed)
    grid = build_tet_grid(res)
    p = {"mov": rng.normal(0, 0.02, (grid.n_vertices, 3)).astype(np.float32),
         "feat": rng.normal(0, 1.0, (grid.n_vertices, 4)).astype(np.float32)}
    if empty_half:
        p["feat"][grid.vertices[:, 0] < 0.5, 0] = -8.0
    ts = TetScene.from_grid(grid, coef=2.5, device="cpu")
    js = JScene.from_grid(j_build_grid(res), coef=2.5)
    return (ts, {k: torch.tensor(v) for k, v in p.items()}, js,
            {k: jnp.asarray(v) for k, v in p.items()})


def test_synthetic_scene_matches_jax(scene_data):
    np.testing.assert_array_equal(topt.pixel_grid(5, 7),
                                  jopt.pixel_grid(5, 7))
    images, poses, hwf, splits = scene_data
    j_images, j_poses, j_hwf, j_splits = jopt.make_synthetic_scene(
        n_views=4, height=32, width=32)
    np.testing.assert_allclose(images, j_images, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(poses, j_poses)
    assert hwf == j_hwf
    for a, b in zip(splits, j_splits):
        np.testing.assert_array_equal(a, b)
    assert 0.01 < images[..., 3].mean() < 0.9


def test_calibrations_equal_jax(scene_data):
    images, poses, (h, w, focal), _ = scene_data
    ts, tp, js, jp = _scenes(8)
    assert ts.faces_fx3.shape[0] > 4096  # binning can win
    cams = [jopt.camera_from_blender(p, focal, h, w) for p in poses]
    grid = topt.pixel_grid(h, w)
    for tiles in (16, 0):
        kw = dict(tet_res=8, pixel_sampling=0.5, tile_sampling=tiles,
                  bin_pixel_chunk=128, k=64)
        n_pix = int(0.5 * h * w)
        assert topt.calibrate_bin_cand(
            ts, tp, cams, [0, 1], grid, n_pix, topt.RenderOptConfig(**kw),
            hw=(h, w)) == jopt.calibrate_bin_cand(
            js, jp, cams, [0, 1], grid, n_pix, jopt.RenderOptConfig(**kw),
            hw=(h, w))
        for raw in (False, True):
            got = topt.calibrate_peel_k(ts, tp, cams, [0, 1], grid, n_pix,
                                        topt.RenderOptConfig(**kw),
                                        hw=(h, w), raw=raw)
            assert got == jopt.calibrate_peel_k(
                js, jp, cams, [0, 1], grid, n_pix,
                jopt.RenderOptConfig(**kw), hw=(h, w), raw=raw)


class _Capture:
    """An optimizer that keeps the gradients it is given."""

    def step(self, grads):
        self.grads = grads


def _capture_jax():
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(zeros,
                                        lambda u, s, p=None: (zeros(u), u))


@pytest.mark.parametrize("gridmov", [True, False])
def test_render_step_matches_jax(scene_data, gridmov):
    images, poses, (h, w, focal), _ = scene_data
    ts, tp, js, jp = _scenes(4)
    gt_color, gt_mask = jopt._white_composite(images)
    pick = np.random.default_rng(7).choice(h * w, size=300, replace=False)
    pix = jopt.pixel_grid(h, w)[pick][None]
    gc, gm = gt_color[1].reshape(-1, 3)[pick][None], \
        gt_mask[1].reshape(-1, 1)[pick][None]
    cam = jopt.camera_from_blender(poses[1], focal, h, w)
    kw = dict(k=16, bin_cand=128, bin_pixel_chunk=64)
    j_in = [jnp.asarray(a) for a in (pix, *cam, gc, gm)]
    t_in = [torch.as_tensor(pix), *cam, torch.as_tensor(gc),
            torch.as_tensor(gm)]

    jstep = jopt.make_render_step(js, jopt.DEFAULT_WEIGHTS, gridmov,
                                  jopt.RenderOptConfig(**kw), _capture_jax(),
                                  _capture_jax())
    _, j_gf, j_gm, j_aux = jstep(jp, {"feat": jp["feat"]}, {"mov": jp["mov"]},
                                 *j_in)
    cf, cm = _Capture(), _Capture()
    tstep = topt.make_render_step(ts, topt.DEFAULT_WEIGHTS, gridmov,
                                  topt.RenderOptConfig(**kw), cf, cm)
    t_aux = tstep({k: v.clone() for k, v in tp.items()}, *t_in)
    for name in ("loss_im", "loss_mask", "loss_occ", "total"):
        np.testing.assert_allclose(float(t_aux[name]), float(j_aux[name]),
                                   rtol=1e-5)
    pairs = [(cf.grads[0], j_gf["feat"])]
    if gridmov:
        pairs.append((cm.grads[0], j_gm["mov"]))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())

    # the same step through Adam (b1 0.5) in both
    cfg = topt.RenderOptConfig(**kw)
    tq = {k: v.clone() for k, v in tp.items()}
    opt_f = ClippedAdam([tq["feat"]], 0.05, None, b1=0.5, b2=0.999)
    opt_m = ClippedAdam([tq["mov"]], 5e-4, None, b1=0.5, b2=0.999)
    topt.make_render_step(ts, topt.DEFAULT_WEIGHTS, gridmov, cfg, opt_f,
                          opt_m)(tq, *t_in)
    of, om = optax.adam(0.05, b1=0.5), optax.adam(5e-4, b1=0.5)
    jq, *_ = jopt.make_render_step(
        js, jopt.DEFAULT_WEIGHTS, gridmov, jopt.RenderOptConfig(**kw), of,
        om)(jp, of.init({"feat": jp["feat"]}), om.init({"mov": jp["mov"]}),
            *j_in)
    for k, lr in (("feat", 0.05), ("mov", 5e-4)):
        # atol 1e-5 lr: where |g| is near Adam's eps, the update carries
        # the gradient's rounding
        np.testing.assert_allclose(tq[k].detach().numpy(),
                                   np.asarray(jq[k]), rtol=1e-5,
                                   atol=1e-5 * lr)


def test_optimize_stage_with_carve_matches_jax(scene_data):
    images, poses, hwf, (i_train, _, _) = scene_data
    ts, tp, js, jp = _scenes(4, seed=3, empty_half=True)
    kw = dict(tet_res=4, pixel_sampling=0.5, k=8, delete_every=3,
              delete_threshold=0.05, carve_dilation=0, seed=0)
    n0 = ts.n_tets
    jp2, j_hist, j_info = jopt.optimize_stage(
        js, jp, images, poses, hwf, i_train, jopt.RenderOptConfig(**kw),
        gridmov=True, steps=6, log=None)
    tp2, t_hist, t_info = topt.optimize_stage(
        ts, tp, images, poses, hwf, i_train, topt.RenderOptConfig(**kw),
        gridmov=True, steps=6, log=None)
    assert ts.n_tets == js.n_tets < n0  # a carve ran
    np.testing.assert_array_equal(ts.tets_tx4, js.tets_tx4)
    np.testing.assert_allclose(t_hist, j_hist, rtol=1e-4)
    assert t_info == j_info
    np.testing.assert_allclose(tp2["feat"].detach().numpy(),
                               np.asarray(jp2["feat"]), rtol=1e-4, atol=1e-4)


def test_run_pipeline_records_match_jax():
    data = jopt.make_synthetic_scene(n_views=4, height=16, width=16)
    kw = dict(tet_res=3, sublevels=1, steps_fix=4, steps_mov=4,
              pixel_sampling=0.5, k=8, delete_every=2, seed=1)
    _, _, j_rec = jopt.run_pipeline(*data, jopt.RenderOptConfig(**kw),
                                    log=None)
    scene, params, t_rec = topt.run_pipeline(
        *data, topt.RenderOptConfig(**kw), log=None, device="cpu")
    assert [r["stage"] for r in t_rec] == ["mov", "fix", "mov", "fix"]
    assert t_rec[2]["n_tets"] == 8 * t_rec[1]["n_tets"]
    assert params["feat"].shape[0] == scene.n_points
    for t, j in zip(t_rec, j_rec):
        assert abs(t["psnr"] - j["psnr"]) < 1e-3
        assert {k: v for k, v in t.items() if k not in ("psnr", "mse")} == \
            {k: v for k, v in j.items() if k not in ("psnr", "mse")}


def test_carve_and_subdivide_budget_paths(scene_data):
    """All-tet split under budget; the selective band split when only the
    band fits; no split when nothing fits (the JAX package's rules)."""
    images, poses, hwf, (_, i_val, _) = scene_data
    grid = build_tet_grid(3)
    cfg = dict(tet_res=3, k=4, pixel_sampling=0.5, seed=0)

    scene = TetScene.from_grid(grid, coef=2.5, device="cpu")
    n0 = scene.n_tets
    params = topt.carve_and_subdivide(scene, scene.init_params(), images,
                                      poses, hwf, i_val,
                                      topt.RenderOptConfig(**cfg), log=None)
    assert scene.n_tets == 8 * n0
    assert params["feat"].shape[0] == scene.n_points

    scene = TetScene.from_grid(grid, coef=2.5, device="cpu")
    feat = np.full((scene.n_points, 4), 0.4, np.float32)
    feat[scene.points_px3[:, 0] < 0.0, 0] = 12.0
    alpha = 1.0 / (1.0 + np.exp(-feat[:, 0]))
    flagged = int((alpha[scene.tets_tx4].min(axis=1) < 0.9).sum())
    est = 8 * flagged + (n0 - flagged)
    assert 0 < flagged < n0
    params = {"feat": torch.as_tensor(feat),
              "mov": torch.zeros((scene.n_points, 3))}
    params = topt.carve_and_subdivide(
        scene, params, images, poses, hwf, i_val,
        topt.RenderOptConfig(tet_budget=est, **cfg), log=None)
    assert scene.n_tets == est

    scene = TetScene.from_grid(grid, coef=2.5, device="cpu")
    params = topt.carve_and_subdivide(
        scene, scene.init_params(), images, poses, hwf, i_val,
        topt.RenderOptConfig(tet_budget=n0 + 1, **cfg), log=None)
    assert scene.n_tets == n0


def test_load_blender_matches_jax(tmp_path):
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        frames = []
        for i in range(n):
            name = f"r_{split}_{i}"
            imageio.imwrite(tmp_path / f"{name}.png",
                            rng.integers(0, 256, (8, 8, 4), dtype=np.uint8))
            pose = np.eye(4)
            pose[:3, 3] = [i, 0.0, 4.0]
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": pose.tolist()})
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    for half in (False, True):
        got = topt.load_blender(str(tmp_path), half_res=half)
        want = jopt.load_blender(str(tmp_path), half_res=half)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        for a, b in zip(got[3], want[3]):
            np.testing.assert_array_equal(a, b)


def test_write_video_and_its_npz_fallback(tmp_path, monkeypatch):
    frames = (np.random.default_rng(0).random((3, 16, 16, 3)) * 255
              ).astype(np.uint8)
    gif = topt.write_video(frames, str(tmp_path / "v.gif"), log=None)
    assert gif.endswith(".gif") and os.path.getsize(gif) > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    said = []
    path = topt.write_video(frames, str(tmp_path / "w.mp4"), log=said.append)
    assert path == str(tmp_path / "w.npz") and said
    with np.load(path) as z:
        np.testing.assert_array_equal(z["frames"], frames)


def test_cli_render_on_cpu(tmp_path):
    rc = cli.main([
        "render", "--device", "cpu", "--synthetic", "--n_views", "4",
        "--image_size", "16", "--tetres", "3", "--sublevel", "0",
        "--optfixnum", "4", "--optmovnum", "3", "--deletenum", "2",
        "--peel_k", "4", "--savedir", str(tmp_path), "--expname", "t",
    ])
    assert rc == 0
    out = tmp_path / "t"
    rec = json.loads((out / "records.json").read_text())
    assert [r["stage"] for r in rec["stages"]] == ["mov", "fix"]
    assert np.isfinite(rec["final_psnr"])
    names = os.listdir(out)
    assert "surface.obj" in names
    assert any(n.endswith(".gif") for n in names)
