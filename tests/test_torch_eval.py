"""The port's evaluation against the JAX package: point-in-tet, the
predicted-surface extraction, every metric, the mesh sampler, the
validation step and the whole inference step at res 4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu.data.pipeline import make_example as jax_make_example
from deftet_tpu.data.shapes import random_shape as jax_random_shape
from deftet_tpu.evals import harness as jax_harness
from deftet_tpu.evals import metrics as jax_metrics
from deftet_tpu.losses import surface as jax_surface
from deftet_tpu.ops import nearest as jax_nearest
from deftet_tpu.ops import nearest_pallas
from deftet_tpu.ops import point_tet as jax_point_tet
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import TrainState
from deftet_tpu.train.step import make_eval_step as jax_make_eval_step
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.evals import harness, metrics
from deftet_tpu_torch.losses import surface
from deftet_tpu_torch.ops import point_tet
from deftet_tpu_torch.tetgrid import build_tet_grid, face_lattice_info
from deftet_tpu_torch.train import Engine, eval_step, statics

_EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture
def pallas_nn(monkeypatch):
    """The JAX package's nearest neighbour through its Pallas kernel in
    interpret mode (direct differences, as the port computes them), not
    the CPU path's |a|^2 + |b|^2 - 2ab expansion, so that near-ties break
    the same way."""
    monkeypatch.setattr(jax_nearest, "_use_pallas_auto", lambda: True)
    monkeypatch.setattr(
        nearest_pallas, "nearest_neighbor_pallas",
        functools.partial(nearest_pallas.nearest_neighbor_pallas,
                          interpret=True))


@pytest.fixture(scope="module")
def grid4():
    res = 4
    grid = jax_grid(res)
    jstat = jax_statics.build_grid_statics(res, grid=grid)
    pstat = statics.build_grid_statics(res)
    return res, face_lattice_info(build_tet_grid(res)), jstat, pstat


def _soa(pos_bxnx3, tet_tx4):
    """soa[k][c] = (B, T) corner coordinates, as numpy."""
    return [[pos_bxnx3[:, tet_tx4[:, k], c] for c in range(3)]
            for k in range(4)]


def test_points_in_tets_and_paste_match_reference(grid4):
    _, _, jstat, pstat = grid4
    rng = np.random.default_rng(0)
    init = pstat.init_pos_nx3.numpy()
    # batch 0: the undeformed grid, queried also at the centers of its
    # faces and cells (points shared by two or more tets: lowest index
    # wins); batch 1: deformed interior vertices
    mask = pstat.pos_mask_nx3.numpy()
    pos = np.stack([init, init + mask * rng.uniform(-0.05, 0.05, init.shape)]
                   ).astype(np.float32)
    tets = pstat.tet_tx4.numpy()
    q = rng.uniform(-0.6, 0.6, (2, 1500, 3)).astype(np.float32)
    lattice_pts = np.stack(np.meshgrid(*[np.arange(-0.5, 0.51, 0.125)] * 3,
                                       indexing="ij"), -1).reshape(-1, 3)
    q[0, :lattice_pts.shape[0]] = lattice_pts
    soa = _soa(pos, tets)
    ref = np.asarray(jax_point_tet.points_in_tets_soa(
        [[jnp.asarray(c) for c in k] for k in soa], jnp.asarray(q)))
    got = point_tet.points_in_tets_soa(
        [[torch.tensor(c) for c in k] for k in soa], torch.tensor(q),
        chunk=100, query_chunk=512)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == -1).any() and (ref >= 0).mean() > 0.4

    occ = rng.uniform(size=(2, tets.shape[0])).astype(np.float32)
    ref_p = np.asarray(jax_point_tet.paste_occupancy(jnp.asarray(occ),
                                                     jnp.asarray(ref)))
    got_p = point_tet.paste_occupancy(torch.tensor(occ), got)
    np.testing.assert_array_equal(got_p.numpy(), ref_p)


def test_boundary_faces_and_subset_match_reference(grid4):
    # the port derives the faces from the lattice classes, the JAX
    # package gathers them through the owning tets
    _, face_lattice, jstat, pstat = grid4
    occ = (np.random.default_rng(1).uniform(size=(2, pstat.n_tets)) < 0.3
           ).astype(np.float32)
    faces_ref, mask_ref = jax_surface.boundary_faces_from_occupancy(
        jnp.asarray(occ), jstat.face_fx3, jstat.face_tet_fx2)
    faces, mask = surface.boundary_faces_from_occupancy(
        torch.tensor(occ), pstat.face_fx3, face_lattice)
    np.testing.assert_array_equal(faces.numpy(), np.asarray(faces_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    n_boundary = int(mask.sum(dim=1).max())
    for k in (n_boundary // 2, n_boundary + 40):  # overflow and slack
        sf_ref, sm_ref = jax_surface.select_boundary_subset(faces_ref,
                                                            mask_ref, k)
        sf, sm = surface.select_boundary_subset(faces, mask, k)
        np.testing.assert_array_equal(sf.numpy(), np.asarray(sf_ref))
        np.testing.assert_array_equal(sm.numpy(), np.asarray(sm_ref))


def _jax_sample_draws(key, face_pos, mask, n):
    """The draws of deftet_tpu.evals.harness.sample_mesh_points for
    ``key``: face ids from its categorical, then the two uniforms."""
    a, b, c = face_pos[:, :, 0], face_pos[:, :, 1], face_pos[:, :, 2]
    cross = jnp.cross(b - a, c - a)
    area = 0.5 * jnp.sqrt(jnp.sum(cross * cross, axis=-1) + 1e-20)
    k_face, k_uv = jax.random.split(key)
    face_id = jax.random.categorical(
        k_face, jnp.log(area * mask + 1e-20)[:, None, :], axis=-1,
        shape=(face_pos.shape[0], n))
    u = jax.random.uniform(k_uv, face_id.shape + (1,))
    v = jax.random.uniform(jax.random.fold_in(k_uv, 1), face_id.shape + (1,))
    return tuple(torch.tensor(np.asarray(x)) for x in (face_id, u, v))


def test_sample_mesh_points_matches_reference():
    rng = np.random.default_rng(2)
    face_pos = rng.uniform(-0.5, 0.5, (2, 40, 3, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 40)) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_harness.sample_mesh_points(
        key, jnp.asarray(face_pos), jnp.asarray(mask), 500))
    draws = _jax_sample_draws(key, jnp.asarray(face_pos), jnp.asarray(mask),
                              500)
    got = harness.sample_mesh_points(torch.tensor(face_pos),
                                     torch.tensor(mask), 500, draws=draws)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    # the port's own draws: only unmasked faces, area-weighted
    gen = torch.Generator().manual_seed(0)
    own = harness.sample_mesh_points(torch.tensor(face_pos),
                                     torch.tensor(mask), 500, generator=gen)
    assert own.shape == (2, 500, 3) and bool(torch.isfinite(own).all())


def test_metrics_match_reference(pallas_nn):
    rng = np.random.default_rng(4)
    a = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    # half the points near `a`, so that the radius-0.01 hits are not all
    # zero; the rest uniform
    b = np.concatenate([a[:, :200] + rng.normal(0, 0.004, (2, 200, 3)),
                        rng.uniform(-0.5, 0.5, (2, 250, 3))], 1).astype(
        np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    pairs = [
        (jax_metrics.f_score(ja, jb), metrics.f_score(ta, tb)),
        (jax_metrics.f_score(ja, jb, extend=True),
         metrics.f_score(ta, tb, extend=True)),
        (jax_metrics.chamfer_distance(ja, jb),
         metrics.chamfer_distance(ta, tb)),
        (jax_metrics.chamfer_distance_l1(ja, jb),
         metrics.chamfer_distance_l1(ta, tb)),
    ]
    # soups of faces sharing vertices, none degenerate (a triangle with a
    # repeated corner has no well-conditioned closest point: the JAX
    # package's own XLA and Pallas paths disagree on it)
    def faces(n_verts, n_faces):
        return np.stack([[rng.choice(n_verts, 3, replace=False)
                          for _ in range(n_faces)] for _ in range(2)]
                        ).astype(np.int32)

    verts_a = rng.uniform(-0.5, 0.5, (2, 60, 3)).astype(np.float32)
    faces_a = faces(60, 50)
    mask_a = (rng.uniform(size=(2, 50)) < 0.8).astype(np.float32)
    verts_b = rng.uniform(-0.5, 0.5, (2, 40, 3)).astype(np.float32)
    faces_b = faces(40, 70)
    mask_b = np.ones((2, 70), np.float32)
    mask_b[1, 55:] = 0
    args = (verts_a, faces_a, mask_a, verts_b, faces_b, mask_b, a, b)
    h_ref = jax_metrics.hausdorff_distance(*map(jnp.asarray, args))
    h = metrics.hausdorff_distance(*map(torch.tensor, args))
    pairs += list(zip(h_ref, h))
    for i, (ref, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-7, err_msg=str(i))
    assert 0.0 < float(pairs[0][1].min()) and float(pairs[0][1].max()) < 1.0
    p = (rng.uniform(size=1000) < 0.5).astype(np.float32)
    t = rng.uniform(size=1000).astype(np.float32)
    assert float(metrics.iou(torch.tensor(p), torch.tensor(t), 0.3)) == \
        float(jax_metrics.iou(jnp.asarray(p), jnp.asarray(t), 0.3))


@pytest.fixture(scope="module")
def small_model():
    jcfg, cfg = tp.configs()
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    lattice = dict(
        lattice_offsets=jax_statics.lattice_offsets(grid),
        tet_lattice=jax_statics.lattice_tet_offsets(grid),
    )
    return jstat, model, variables, lattice, jax_fl(grid)


def test_eval_step_matches_reference(small_model):
    jstat, model, variables, lattice, fl = small_model
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6)
    batch = tp.batch(cfg, seed=6)
    rng = jax.random.PRNGKey(8)
    state = TrainState(variables["params"], variables["batch_stats"], None,
                       jnp.zeros((), jnp.int32))
    step = jax_make_eval_step(model, jcfg, face_lattice=fl, **lattice)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = step.lower(state, jbatch, rng, jstat).compile(
        compiler_options=_EXACT)(state, jbatch, rng, jstat)

    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    stats_before = {k: v.clone() for k, v in engine.model.named_buffers()}
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    shape = (2, jcfg.resolved_max_boundary_faces(), jcfg.per_face_samples, 1)
    draws = {"bary_u": torch.tensor(np.asarray(jax.random.uniform(ku, shape))),
             "bary_v": torch.tensor(np.asarray(jax.random.uniform(kv, shape)))}
    terms = eval_step(engine.model, engine._prep_batch(batch), engine.statics,
                      cfg, engine.generator, draws=draws, **engine._lattice())
    assert set(terms) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(float(terms[name]), float(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for k, v in engine.model.named_buffers():  # BatchNorm in eval mode
        assert torch.equal(v, stats_before[k]), k


def _eval_batch(n_surface=256, n_sdf=400):
    """Two shapes from the JAX package's make_example, padded as
    ShapeDataset pads them."""
    exs = []
    for seed in (1, 2):
        verts, faces = jax_random_shape(seed, level=1)
        exs.append(jax_make_example(verts, faces, n_surface, n_sdf,
                                    np.random.default_rng(seed),
                                    occ_grid_res=16))
    nv = max(e["verts"].shape[0] for e in exs)
    nf = max(e["faces"].shape[0] for e in exs) + 5
    batch = {k: np.stack([e[k] for e in exs])
             for k in ("surface_points", "sdf_points", "sdf", "occ_grid")}
    batch["verts"] = np.zeros((2, nv, 3), np.float32)
    batch["faces"] = np.zeros((2, nf, 3), np.int32)
    batch["n_faces"] = np.zeros((2,), np.int32)
    for i, e in enumerate(exs):
        batch["verts"][i, :e["verts"].shape[0]] = e["verts"]
        batch["faces"][i, :e["faces"].shape[0]] = e["faces"]
        batch["n_faces"][i] = e["faces"].shape[0]
    return batch


def test_inference_step_matches_reference(small_model, pallas_nn):
    jstat, model, variables, lattice, _ = small_model
    # eval_points past the 256 stored surface points: the GT mesh is
    # resampled too
    jcfg, cfg = tp.configs(eval_points=300)
    batch = _eval_batch()
    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    pbatch = engine._prep_batch(batch)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.seed), (2, jcfg.n_point, 3)))

    # an occupancy threshold between two neighbouring probabilities near
    # the median, so that the predicted surface is not empty and no
    # probability sits near the threshold
    _, _, logits = harness._predict(
        engine.model, pbatch, engine.statics, cfg, engine.lattice_offsets,
        engine.tet_lattice, noise=torch.tensor(noise))
    probs = np.sort(torch.sigmoid(logits).numpy().reshape(-1))
    i = len(probs) // 2 + int(np.argmax(np.diff(probs[len(probs) // 2:])))
    thresh = float((probs[i] + probs[i + 1]) / 2)
    assert probs[i + 1] - probs[i] > 1e-5
    jcfg.occ_threshold = cfg.occ_threshold = thresh

    # the JAX step's own draws: its input noise, and the samplers' keys
    state = TrainState(variables["params"], variables["batch_stats"], None,
                       jnp.zeros((), jnp.int32))
    noisy = dict(batch)
    noisy["surface_points"] = batch["surface_points"].copy()
    noisy["surface_points"][:, :jcfg.n_point] += jcfg.input_noise * noise
    jnoisy = {k: jnp.asarray(v) for k, v in noisy.items()}
    tet_pos, work_faces, work_mask = jax_harness.extract_predicted_surface(
        model, state, jnoisy, jstat, jcfg, **lattice)
    face_pos = tet_pos[np.arange(2)[:, None, None], work_faces]
    gt_tri = batch["verts"][np.arange(2)[:, None, None], batch["faces"]]
    gt_mask = (np.arange(batch["faces"].shape[1])[None]
               < batch["n_faces"][:, None]).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    k_pred, k_gt = jax.random.split(rng)
    draws = {
        "noise": torch.tensor(noise),
        "pred": _jax_sample_draws(k_pred, jnp.asarray(face_pos),
                                  jnp.asarray(work_mask), 300),
        "gt": _jax_sample_draws(k_gt, jnp.asarray(gt_tri),
                                jnp.asarray(gt_mask), 300),
    }
    infer_ref = jax_harness.make_inference_step(model, jcfg, **lattice)
    ref = infer_ref(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, jstat)
    got = engine.inference_step()(pbatch, engine.statics, draws=draws)

    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(float(got[name]), float(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(got["n_boundary"]) > 0
    for name in ("chamfer", "chamfer_l1", "hausdorff", "hausdorff_max"):
        assert float(got[name]) > 0, name
