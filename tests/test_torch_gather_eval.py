"""The general grid's evaluation and engine: the inference step on a 1->8
split grid (not a lattice) against the JAX package's ``make_inference_step``
without lattice arguments, float32 rtol 1e-4, and an ``Engine`` built on
that grid's statics taking two grad_accum=2 + remat steps at budget 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_eval as te
import torch_parity as tp
from deftet_tpu.evals import harness as jax_harness
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import TrainState
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.evals import harness
from deftet_tpu_torch.train import Engine, statics


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    jgrid, pgrid = tp.split_grid(tmp_path_factory.mktemp("g") / "s.tet")
    jstat = jax_statics.build_grid_statics(4, grid=jgrid)
    return jstat, statics.build_grid_statics(4, grid=pgrid)


def test_inference_step_on_split_grid_matches_reference(split):
    jstat, pstat = split
    jcfg, cfg = tp.configs(eval_points=300)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    batch = te._eval_batch()
    engine = Engine(cfg, device="cpu", statics=pstat)
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    pbatch = engine._prep_batch(batch)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.seed), (2, jcfg.n_point, 3)))
    # a threshold in the widest gap above the median probability
    _, _, logits = harness._predict(engine.model, pbatch, engine.statics,
                                    cfg, noise=torch.tensor(noise))
    probs = np.sort(torch.sigmoid(logits).numpy().reshape(-1))
    i = len(probs) // 2 + int(np.argmax(np.diff(probs[len(probs) // 2:])))
    assert probs[i + 1] - probs[i] > 1e-5
    jcfg.occ_threshold = cfg.occ_threshold = float((probs[i] + probs[i + 1])
                                                   / 2)

    state = TrainState(variables["params"], variables["batch_stats"], None,
                       jnp.zeros((), jnp.int32))
    noisy = dict(batch)
    noisy["surface_points"] = batch["surface_points"].copy()
    noisy["surface_points"][:, :jcfg.n_point] += jcfg.input_noise * noise
    tet_pos, work_faces, work_mask = jax_harness.extract_predicted_surface(
        model, state, {k: jnp.asarray(v) for k, v in noisy.items()}, jstat,
        jcfg)
    face_pos = tet_pos[np.arange(2)[:, None, None], work_faces]
    gt_tri = batch["verts"][np.arange(2)[:, None, None], batch["faces"]]
    gt_mask = (np.arange(batch["faces"].shape[1])[None]
               < batch["n_faces"][:, None]).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    k_pred, k_gt = jax.random.split(rng)
    draws = {"noise": torch.tensor(noise),
             "pred": te._jax_sample_draws(k_pred, jnp.asarray(face_pos),
                                          jnp.asarray(work_mask), 300),
             "gt": te._jax_sample_draws(k_gt, jnp.asarray(gt_tri),
                                        jnp.asarray(gt_mask), 300)}
    ref = jax_harness.make_inference_step(model, jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng, jstat)
    got = engine.inference_step()(pbatch, engine.statics, draws=draws)
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(float(got[name]), float(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(got["n_boundary"]) > 0


def test_engine_trains_on_given_statics(split):
    _, pstat = split
    _, cfg = tp.configs(max_boundary_faces=0, grad_accum=2, remat=True)
    engine = Engine(cfg, device="cpu", statics=pstat)
    assert engine.statics.lattice is None
    batch = engine._prep_batch(tp.batch(cfg))
    before = [p.detach().clone() for p in engine.model.parameters()]
    for _ in range(2):
        terms = engine.train_step(batch)
        assert all(np.isfinite(float(v)) for v in terms.values())
    assert terms["boundary_overflow"] == 0.0
    assert any(not torch.equal(a, b) for a, b in
               zip(before, engine.model.parameters()))
    assert engine.global_step == 2
