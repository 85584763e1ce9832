"""The port's render camera, compositing, topology copies, frame lists and
tet scene against the JAX package's, on the CPU.

Camera and compositing hold to rtol 1e-6 (atol 1e-6 for the camera's
cancelling dot products, 1e-7 for compositing);
the numpy copies (topology builders, subdivision, .tet IO, tile layout,
frame lists, carving, the surface OBJ) must be exactly equal.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.render import camera as jcam
from deftet_tpu.render import composite as jcomp
from deftet_tpu.render import frame as jframe
from deftet_tpu.render.optimize import RenderOptConfig as JCfg
from deftet_tpu.render.optimize import render_full_image as j_full_image
from deftet_tpu.render.scene import TetScene as JScene
from deftet_tpu.tetgrid import build_tet_grid as j_build_grid
from deftet_tpu.tetgrid import grid as jgrid
from deftet_tpu.tetgrid import subdivide as jsub
from deftet_tpu.tetgrid import topology as jtopo
from deftet_tpu_torch.convert import render_params_from_numpy
from deftet_tpu_torch.render import camera as tcam
from deftet_tpu_torch.render import composite as tcomp
from deftet_tpu_torch.render import frame as tframe
from deftet_tpu_torch.render.optimize import RenderOptConfig as TCfg
from deftet_tpu_torch.render.optimize import pixel_grid, render_full_image
from deftet_tpu_torch.render.scene import TetScene
from deftet_tpu_torch.tetgrid import build_tet_grid
from deftet_tpu_torch.tetgrid import grid as tgrid
from deftet_tpu_torch.tetgrid import subdivide as tsub
from deftet_tpu_torch.tetgrid import topology as ttopo

ASSET = Path(__file__).resolve().parent / "assets" / "bench_scene.npz"


def _params(n, seed=0, mov=0.02, feat=2.0):
    rng = np.random.default_rng(seed)
    return {"mov": rng.normal(0, mov, (n, 3)).astype(np.float32),
            "feat": rng.normal(0, feat, (n, 4)).astype(np.float32)}


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _port(p):
    return render_params_from_numpy(p, "cpu")


def test_camera_matches_jax():
    rng = np.random.default_rng(0)
    for theta, phi in ((30.0, -25.0), (-140.0, -70.0)):
        np.testing.assert_array_equal(tcam.pose_spherical(theta, phi, 4.0),
                                      jcam.pose_spherical(theta, phi, 4.0))
        c2w = tcam.pose_spherical(theta, phi, 4.0)
        for a, b in zip(tcam.camera_from_blender(c2w, 40.0, 30, 40),
                        jcam.camera_from_blender(c2w, 40.0, 30, 40)):
            np.testing.assert_array_equal(a, b)
        rot, pos, proj = tcam.camera_from_blender(c2w, 40.0, 30, 40)
        pts = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
        rot2, pos2 = np.repeat(rot, 2, 0), np.repeat(pos, 2, 0)
        got = tcam.perspective(*map(torch.as_tensor, (pts, rot2, pos2,
                                                      proj)))
        want = jcam.perspective(*map(jnp.asarray, (pts, rot2, pos2, proj)))
        for g, w in zip(got, want):
            # atol: a coordinate that the 3-term dot product of O(1) terms
            # cancels to near 0 keeps the terms' absolute rounding
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_composite_matches_jax():
    rng = np.random.default_rng(1)
    layers = rng.uniform(0, 1, (2, 30, 6, 4)).astype(np.float32)
    layers[0, :5, :, 0] = 0.0     # empty layers clip to EPS
    layers[1, :5, 0, 0] = 1.0     # an opaque front layer
    depth = rng.uniform(-5, -1, (2, 30, 6, 1)).astype(np.float32)
    got = tcomp.peel2mask(torch.as_tensor(layers), torch.as_tensor(depth))
    want = jcomp.peel2mask(jnp.asarray(layers), jnp.asarray(depth))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    faces = rng.integers(0, 10, (7, 3)).astype(np.int32)
    vert = rng.normal(size=(2, 10, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tcomp.vertex2face(torch.as_tensor(vert), torch.as_tensor(faces)),
        np.asarray(jcomp.vertex2face(jnp.asarray(vert), jnp.asarray(faces))))


def _carved_tets(res=3):
    grid = build_tet_grid(res)
    keep = np.random.default_rng(2).random(grid.n_tets) < 0.7
    return grid, grid.tets[keep]


def test_topology_copies_equal_jax():
    grid, tets = _carved_tets()
    n = grid.n_vertices
    for a, b in zip(ttopo.build_vertex_adjacency(tets, n),
                    jtopo.build_vertex_adjacency(tets, n)):
        np.testing.assert_array_equal(a, b)
    _, ft, fs, hull = ttopo.build_faces(tets, n)
    np.testing.assert_array_equal(
        ttopo.build_tet_neighbors(ft, fs, tets.shape[0]),
        jtopo.build_tet_neighbors(ft, fs, tets.shape[0]))
    np.testing.assert_array_equal(ttopo.hull_face_owners(tets, hull, n),
                                  jtopo.hull_face_owners(tets, hull, n))
    np.testing.assert_array_equal(ttopo.TET_EDGES, jtopo.TET_EDGES)
    from deftet_tpu.render.scene import build_render_faces as jfaces
    from deftet_tpu_torch.render.scene import build_render_faces

    np.testing.assert_array_equal(build_render_faces(tets, n),
                                  jfaces(tets, n))


def test_subdivide_and_delete_equal_jax():
    grid, tets = _carved_tets()
    pts = grid.centered_vertices().astype(np.float32)
    feats = np.random.default_rng(3).normal(size=(pts.shape[0], 7)).astype(
        np.float32)
    flag = np.random.default_rng(4).random(tets.shape[0]) < 0.5
    for f in (None, flag):
        for a, b in zip(tsub.subdivide_tets(tets, pts, feats, f),
                        jsub.subdivide_tets(tets, pts, feats, f)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsub.delete_tets(tets, feats[:, 0], 0.1),
                                  jsub.delete_tets(tets, feats[:, 0], 0.1))


def test_tet_file_io_equal_jax(tmp_path):
    grid = build_tet_grid(3)
    tgrid.save_tet_file(grid, str(tmp_path / "port.tet"))
    jgrid.save_tet_file(j_build_grid(3), str(tmp_path / "jax.tet"))
    assert (tmp_path / "port.tet").read_bytes() == \
        (tmp_path / "jax.tet").read_bytes()
    got = tgrid.read_tet_file(str(tmp_path / "port.tet"))
    want = jgrid.read_tet_file(str(tmp_path / "port.tet"))
    for name in ("vertices", "tets", "interior_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_frame_layout_and_bins_equal_jax():
    for h, w, t in ((32, 32, 16), (30, 20, 16), (7, 9, 4)):
        a, shape_a = tframe.tile_pixel_layout(h, w, t)
        b, shape_b = jframe.tile_pixel_layout(h, w, t)
        np.testing.assert_array_equal(a, b)
        assert shape_a == shape_b
    rng = np.random.default_rng(0)
    tri = (rng.uniform(-1.1, 1.1, (300, 1, 2))
           + rng.normal(0, 0.15, (300, 3, 2))).astype(np.float32)
    h, w, tile = 40, 36, 8
    offsets, cand = tframe.build_frame_bins(tri, h, w, tile)
    want = {}
    for _, (ids, c) in jframe.build_frame_bins(tri, h, w, tile,
                                               min_budget=4).items():
        for i, t in enumerate(ids):
            want[int(t)] = c[i][c[i] >= 0].tolist()
    n_tiles = -(-h // tile) * -(-w // tile)
    assert offsets.shape == (n_tiles + 1,)
    for t in range(n_tiles):
        assert cand[offsets[t]:offsets[t + 1]].tolist() == want.get(t, [])


def _scenes(res=3, seed=0):
    grid = build_tet_grid(res)
    p = _params(grid.n_vertices, seed)
    return (TetScene.from_grid(grid, coef=2.0, device="cpu"), _port(p),
            JScene.from_grid(j_build_grid(res), coef=2.0), _jax(p))


def test_scene_render_laplacian_carve_obj_subdivide_equal_jax(tmp_path):
    ts, tp, js, jp = _scenes()
    rot, pos, proj = np.eye(3, dtype=np.float32)[None], \
        np.asarray([[0.0, 0.0, 4.0]], np.float32), \
        np.asarray([2.0, 2.0, 1.0], np.float32)
    pix = np.random.default_rng(5).uniform(-0.5, 0.5, (1, 60, 2)).astype(
        np.float32)
    got = ts.render(tp, pix, rot, pos, proj, k=6, depth=True)
    want = js.render(jp, jnp.asarray(pix), *map(jnp.asarray,
                                                (rot, pos, proj)),
                     k=6, depth=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(6).normal(size=(ts.n_points, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        ts.feature_laplacian(torch.as_tensor(x)).numpy(),
        np.asarray(js.feature_laplacian(jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)

    assert ts.carve(tp, 0.55, neighbor_levels=0) is True
    assert js.carve(jp, 0.55, neighbor_levels=0) is True
    np.testing.assert_array_equal(ts.tets_tx4, js.tets_tx4)
    np.testing.assert_array_equal(ts.faces_fx3, js.faces_fx3)
    np.testing.assert_array_equal(ts.tet_neighbor_tx4, js.tet_neighbor_tx4)
    assert ts.save_surface_obj(tp, str(tmp_path / "port.obj")) == \
        js.save_surface_obj(jp, str(tmp_path / "jax.obj"))
    assert (tmp_path / "port.obj").read_bytes() == \
        (tmp_path / "jax.obj").read_bytes()

    tp2, jp2 = ts.subdivide(tp, 0.5), js.subdivide(jp, 0.5)
    np.testing.assert_array_equal(ts.tets_tx4, js.tets_tx4)
    np.testing.assert_array_equal(ts.points_px3, js.points_px3)
    for k in ("mov", "feat"):
        np.testing.assert_array_equal(tp2[k].numpy(), np.asarray(jp2[k]))


def test_state_files_cross_load(tmp_path):
    """The port reads the JAX package's npz (the bundled carved snapshot
    and a fresh save) and writes one the JAX package reads back."""
    ts, tp, js, jp = _scenes(seed=1)
    js.save_state(str(tmp_path / "jax.npz"), jp)
    ts.save_state(str(tmp_path / "port.npz"), tp)
    for path in (ASSET, tmp_path / "jax.npz", tmp_path / "port.npz"):
        got_s, got_p = TetScene.load_state(str(path), device="cpu")
        want_s, want_p = JScene.load_state(str(path))
        for name in ("points_px3", "tets_tx4", "faces_fx3", "adj_idx",
                     "tet_neighbor_tx4"):
            np.testing.assert_array_equal(getattr(got_s, name),
                                          getattr(want_s, name))
        assert (got_s.coef, got_s.feat_dim) == (want_s.coef, want_s.feat_dim)
        for k in ("mov", "feat"):
            np.testing.assert_array_equal(got_p[k].numpy(),
                                          np.asarray(want_p[k]))
    with pytest.raises(ValueError):
        render_params_from_numpy({"mov": np.zeros((2, 3))})


def test_full_frame_equals_chunked_and_jax():
    """The per-tile-list frame equals an unbinned render of every pixel
    (the JAX package's own frame test tolerance, atol 2e-5), the JAX
    package's pixel-chunked frame and its per-tile-list frame."""
    ts, tp, js, jp = _scenes(res=5, seed=3)
    pose = tcam.pose_spherical(30.0, -25.0, 4.0)
    h, w = 22, 26
    hwf = (h, w, 0.5 * w / np.tan(0.5 * 0.69))
    base = dict(k=64, raster_chunk=256, seed=0)
    c_new, m_new = render_full_image(ts, tp, pose, hwf,
                                     TCfg(frame_tile=16, **base))
    cam = tcam.camera_from_blender(pose, hwf[2], h, w)
    with torch.no_grad():
        c_ref, m_ref = ts.render(tp, pixel_grid(h, w)[None], *cam, k=64,
                                 chunk=256, bin_cand=0)[:2]
    c_ref = c_ref[0].numpy().reshape(h, w, 3)
    m_ref = m_ref[0].numpy().reshape(h, w, 1)
    np.testing.assert_allclose(c_new, c_ref, atol=2e-5)
    np.testing.assert_allclose(m_new, m_ref, atol=2e-5)
    c_chunk, m_chunk = j_full_image(js, jp, pose, hwf,
                                    JCfg(frame_tile=0, **base))
    np.testing.assert_allclose(c_new, c_chunk, atol=2e-5)
    np.testing.assert_allclose(m_new, m_chunk, atol=2e-5)
    np.testing.assert_allclose(m_new, m_ref, atol=2e-5)
    assert m_new.max() > 0.5
    c_jax, m_jax = j_full_image(js, jp, pose, hwf,
                                JCfg(frame_tile=16, frame_min_faces=1,
                                     **base))
    np.testing.assert_allclose(c_new, c_jax, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(m_new, m_jax, rtol=1e-5, atol=2e-5)
