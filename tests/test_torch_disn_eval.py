"""The inference step of the image-conditioned network with the lap layer
against the JAX package's make_inference_step, on the CPU at res 4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_eval as te
import test_torch_lap as tl
import torch_parity as tp
from deftet_tpu.data.image_render import random_camera
from deftet_tpu.evals import harness as jax_harness
from deftet_tpu.ops import nearest as jax_nearest
from deftet_tpu.ops import nearest_pallas
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import TrainState
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.evals import harness
from deftet_tpu_torch.train import Engine


def test_inference_step_matches_reference(monkeypatch):
    """The whole inference step in DISN mode with the lap layer (images
    and cameras in, the lap head at the refined positions, the full-grid
    occupancy decoded with the cameras) against make_inference_step."""
    # the JAX nearest neighbour through its Pallas kernel (interpret
    # mode), so that near-ties break as in the port
    monkeypatch.setattr(jax_nearest, "_use_pallas_auto", lambda: True)
    monkeypatch.setattr(
        nearest_pallas, "nearest_neighbor_pallas",
        functools.partial(nearest_pallas.nearest_neighbor_pallas,
                          interpret=True))
    jcfg, cfg = tp.configs(eval_points=300, **tl.CONFIGS["disn_lap"])
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    lattice = dict(lattice_offsets=jax_statics.lattice_offsets(grid),
                   tet_lattice=jax_statics.lattice_tet_offsets(grid))
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    batch = te._eval_batch()
    rng = np.random.default_rng(12)
    batch["imgs"] = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    batch["cam_matrix"] = np.stack([random_camera(rng) for _ in range(2)])

    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    pbatch = engine._prep_batch(batch)
    # an occupancy threshold between two neighbouring probabilities near
    # the median, as in test_torch_eval
    _, _, logits = harness._predict(engine.model, pbatch, engine.statics,
                                    cfg)
    probs = np.sort(torch.sigmoid(logits).numpy().reshape(-1))
    i = len(probs) // 2 + int(np.argmax(np.diff(probs[len(probs) // 2:])))
    jcfg.occ_threshold = cfg.occ_threshold = float(
        (probs[i] + probs[i + 1]) / 2)
    assert probs[i + 1] - probs[i] > 1e-5

    state = TrainState(variables["params"], {}, None,
                       jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tet_pos, work_faces, work_mask = jax_harness.extract_predicted_surface(
        model, state, jbatch, jstat, jcfg, **lattice)
    face_pos = tet_pos[np.arange(2)[:, None, None], work_faces]
    gt_tri = batch["verts"][np.arange(2)[:, None, None], batch["faces"]]
    gt_mask = (np.arange(batch["faces"].shape[1])[None]
               < batch["n_faces"][:, None]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k_pred, k_gt = jax.random.split(key)
    draws = {
        "pred": te._jax_sample_draws(k_pred, jnp.asarray(face_pos),
                                     jnp.asarray(work_mask), 300),
        "gt": te._jax_sample_draws(k_gt, jnp.asarray(gt_tri),
                                   jnp.asarray(gt_mask), 300),
    }
    ref = jax_harness.make_inference_step(model, jcfg, **lattice)(
        state, jbatch, key, jstat)
    got = engine.inference_step()(pbatch, engine.statics, draws=draws)
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(float(got[name]), float(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(got["n_boundary"]) > 0
