"""The port's train loop against the JAX package: the cosine lr, a
``grad_accum=2`` step (terms, updated parameters, BatchNorm statistics),
rematerialization against none, and the ``check_sign`` occupancy source."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from deftet_tpu.ops.check_sign import check_sign as jax_check_sign
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import TrainState
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu.train.step import make_optimizer as jax_make_optimizer
from deftet_tpu.train.step import make_train_step as jax_make_train_step
from deftet_tpu_torch import remat
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.data.shapes import random_shape
from deftet_tpu_torch.ops import nearest, tri_distance
from deftet_tpu_torch.ops.check_sign import check_sign
from deftet_tpu_torch.train import Engine
from deftet_tpu_torch.train.step import ClippedAdam

# XLA would otherwise keep the normal loss's bf16 slice sums in f32; the
# port, like the JAX code read eagerly, rounds each (see test_torch_step)
_EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX statics, model, variables and lattice info of the small
    configuration (the model's widths do not depend on the fields the
    tests below change)."""
    jcfg, _ = tp.configs()
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    lattice = dict(
        lattice_offsets=jax_statics.lattice_offsets(grid),
        tet_lattice=jax_statics.lattice_tet_offsets(grid),
        face_lattice=jax_fl(grid),
    )
    return jstat, model, variables, lattice


def _bary(rng, jcfg, b):
    """The JAX step's chamfer barycentrics for ``rng`` (surface.py:85-87)."""
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    shape = (b, jcfg.resolved_max_boundary_faces(), jcfg.per_face_samples, 1)
    return {"bary_u": torch.tensor(np.asarray(jax.random.uniform(ku, shape))),
            "bary_v": torch.tensor(np.asarray(jax.random.uniform(kv, shape)))}


@pytest.mark.parametrize("decay_steps,final_scale", [(5, 0.1), (3, 0.0)])
def test_cosine_lr_matches_optax(decay_steps, final_scale):
    sched = optax.cosine_decay_schedule(1e-3, decay_steps, alpha=final_scale)
    opt = ClippedAdam([torch.zeros(1)], lr=1e-3, decay_steps=decay_steps,
                      final_scale=final_scale)
    got = [opt.lr_at(n) for n in range(decay_steps + 3)]
    ref = [float(sched(n)) for n in range(decay_steps + 3)]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)

    # and the updates: clip + adam(schedule) over D + 2 steps
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32)
             for _ in range(decay_steps + 2)]
    tx = optax.chain(optax.clip_by_global_norm(40.0), optax.adam(sched))
    ref_p = jnp.asarray(p0)
    state = tx.init(ref_p)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
    p = torch.tensor(p0)
    opt = ClippedAdam([p], lr=1e-3, max_norm=40.0, decay_steps=decay_steps,
                      final_scale=final_scale)
    for g in grads:
        opt.step([torch.tensor(g)])
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-6,
                               atol=1e-7)


def test_grad_accum_step_matches_reference(jax_setup):
    # noise off and occ_sample >= n_tets: the barycentrics are the only
    # draws, injected per microbatch from the JAX step's own keys
    jcfg, cfg = tp.configs(batch_size=4, grad_accum=2, add_input_noise=False,
                           occ_sample=10**6, lr_decay_steps=10)
    jstat, model, variables, lattice = jax_setup
    # the step donates (deletes) its input state: give it copies
    variables = jax.tree_util.tree_map(jnp.copy, variables)
    batch = tp.batch(cfg, seed=2)
    rng = jax.random.PRNGKey(7)
    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))

    tx = jax_make_optimizer(jcfg)
    params = variables["params"]
    state = TrainState(params, variables["batch_stats"], tx.init(params),
                       jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, tx, jcfg, **lattice)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = step.lower(state, jbatch, rng, jstat).compile(
        compiler_options=_EXACT)
    new_state, terms_ref = compiled(state, jbatch, rng, jstat)

    draws = [_bary(jax.random.fold_in(rng, i), jcfg, 2) for i in range(2)]
    terms = engine.train_step(engine._prep_batch(batch), draws=draws)

    assert set(terms) == set(terms_ref)
    for name, ref in terms_ref.items():
        np.testing.assert_allclose(float(terms[name]), float(ref),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # BatchNorm statistics threaded through both microbatches
    stats = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    tp.assert_tree_close(tp.numpy_tree(new_state.batch_stats), stats,
                         1e-4, 1e-6, "batch_stats")
    # the averaged gradient, read from Adam's first moment (mu = 0.1 g),
    # at the step test's gradient tolerances (x 0.1)
    names = [n for n, _ in engine.model.named_parameters()]
    mu = tp.flax_layout(engine.model, dict(zip(names, engine.optimizer.mu)))
    mu_ref = tp.numpy_tree(new_state.opt_state[1][0].mu)
    tp.assert_tree_close(mu_ref, mu, 1e-3, 1e-6, "mu")
    # the updated parameters: one Adam step moves each by ~lr * sign(g);
    # where the gradient is ~0 (biases feeding a BatchNorm) its sign is
    # noise in both frameworks, so those entries get 2 lr of slack
    got = tp.flax_layout(engine.model, dict(engine.model.named_parameters()))
    flat_ref = jax.tree_util.tree_flatten_with_path(
        tp.numpy_tree(new_state.params))[0]
    flat_mu = dict(jax.tree_util.tree_flatten_with_path(mu_ref)[0])
    for path, ref in flat_ref:
        key = ".".join(p.key for p in path)
        live = np.abs(flat_mu[path]) > 1e-7
        np.testing.assert_allclose(got[key][live], ref[live], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got[key], ref, rtol=0, atol=2.1 * cfg.lr,
                                   err_msg=key)
    assert engine.optimizer.count == 1


class _Calls:
    """Counts the K2 / K3 wrapper calls behind the surface losses."""

    def __init__(self, monkeypatch):
        self.n = {"nearest": 0, "tri_argmin": 0}
        nn, tri = nearest.nearest_neighbor, tri_distance.tri_argmin

        def counted_nn(*a, **k):
            self.n["nearest"] += 1
            return nn(*a, **k)

        def counted_tri(*a, **k):
            self.n["tri_argmin"] += 1
            return tri(*a, **k)

        monkeypatch.setattr(nearest, "nearest_neighbor", counted_nn)
        monkeypatch.setattr(tri_distance, "tri_argmin", counted_tri)


def test_remat_matches_no_remat(monkeypatch):
    # dropout, input noise and the center subsample all draw from the
    # engine's generator: the recompute must draw the same numbers
    calls = _Calls(monkeypatch)
    _, cfg = tp.configs(occ_sample=64, occ_mlp_hidden="16,0.2,8",
                        pos_mlp_hidden="8,0.3", batch_size=4, grad_accum=2)
    results = []
    for use_remat in (False, True):
        cfg.remat = use_remat
        engine = Engine(cfg, device="cpu")
        batch = engine._prep_batch(tp.batch(cfg, seed=1))
        before = {k: v.clone() for k, v in engine.model.named_buffers()}

        # gradients of one forward, checkpointed or not
        calls.n = {k: 0 for k in calls.n}
        state = engine.generator.get_state()

        def loss():
            return engine.forward_losses(batch, train=True)

        total, _ = (remat.checkpoint(loss, engine.generator, engine.model)
                    if use_remat else loss())
        grads = torch.autograd.grad(total, list(engine.model.parameters()),
                                    allow_unused=True)
        once = dict(calls.n)
        stats_once = {k: v.clone() for k, v in engine.model.named_buffers()}
        after_gen = engine.generator.get_state()

        # then a grad_accum=2 step from the same state
        engine.generator.set_state(state)
        with torch.no_grad():
            for k, v in engine.model.named_buffers():
                v.copy_(before[k])
        calls.n = {k: 0 for k in calls.n}
        terms = engine.train_step(batch)
        results.append(dict(
            grads=grads, once=once, stats_once=stats_once,
            after_gen=after_gen, step_calls=dict(calls.n),
            terms={k: float(v) for k, v in terms.items()},
            params=[p.detach().clone() for p in engine.model.parameters()],
            stats={k: v.clone() for k, v in engine.model.named_buffers()}))

    plain, rem = results
    assert plain["once"] == rem["once"] == {"nearest": 1, "tri_argmin": 1}
    assert plain["step_calls"] == rem["step_calls"] == {"nearest": 2,
                                                        "tri_argmin": 2}
    assert torch.equal(plain["after_gen"], rem["after_gen"])
    for a, b in zip(plain["grads"], rem["grads"]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            torch.testing.assert_close(b, a, rtol=1e-5, atol=0)
    # BatchNorm statistics updated once, not again in the recompute
    for k in plain["stats_once"]:
        torch.testing.assert_close(rem["stats_once"][k],
                                   plain["stats_once"][k], rtol=0, atol=0)
        torch.testing.assert_close(rem["stats"][k], plain["stats"][k],
                                   rtol=0, atol=0)
    assert rem["terms"] == plain["terms"]
    for a, b in zip(plain["params"], rem["params"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-9)


def _gt_mesh(b):
    """A padded batch of GT meshes: (verts, faces, n_faces) numpy."""
    meshes = [random_shape(s, level=1) for s in (0, 5)][:b]
    nv = max(v.shape[0] for v, _ in meshes)
    nf = max(f.shape[0] for _, f in meshes) + 7
    verts = np.zeros((b, nv, 3), np.float32)
    faces = np.zeros((b, nf, 3), np.int32)
    n_faces = np.zeros((b,), np.int32)
    for i, (v, f) in enumerate(meshes):
        verts[i, :v.shape[0]] = v
        faces[i, :f.shape[0]] = f
        n_faces[i] = f.shape[0]
    return verts, faces, n_faces


def test_check_sign_matches_reference():
    verts, faces, n_faces = _gt_mesh(2)
    q = np.random.default_rng(4).uniform(-0.55, 0.55, (2, 3000, 3)).astype(
        np.float32)
    ref = np.asarray(jax_check_sign(jnp.asarray(verts), jnp.asarray(faces),
                                    jnp.asarray(q),
                                    n_valid_faces=jnp.asarray(n_faces)))
    got = check_sign(torch.tensor(verts), torch.tensor(faces),
                     torch.tensor(q), torch.tensor(n_faces), chunk=100,
                     query_chunk=700).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.05 < got.mean() < 0.95


def test_forward_losses_check_sign_matches_reference(jax_setup):
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6,
                           occ_source="check_sign")
    jstat, model, variables, lattice = jax_setup
    verts, faces, n_faces = _gt_mesh(cfg.batch_size)
    batch = {**tp.batch(cfg, seed=3), "verts": verts, "faces": faces,
             "n_faces": n_faces}
    del batch["occ_grid"]
    rng = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def fwd(params):
        total, (terms, mutated) = jax_forward_losses(
            model, {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, jstat, jcfg, rng, train=True, **lattice)
        return total, terms, mutated

    total_ref, terms_ref, mutated = jax.jit(fwd).lower(
        variables["params"]).compile(compiler_options=_EXACT)(
        variables["params"])

    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    total, terms = engine.forward_losses(engine._prep_batch(batch),
                                         train=True,
                                         draws=_bary(rng, jcfg, 2))
    total, terms = total.detach(), {k: v.detach() for k, v in terms.items()}
    assert set(terms) == set(terms_ref)
    for name, ref in terms_ref.items():
        np.testing.assert_allclose(float(terms[name]), float(ref),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(total), float(total_ref), rtol=1e-4)
    assert terms["surf_chamfer"] > 0.0  # the labels put a surface in the grid
    stats = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    tp.assert_tree_close(tp.numpy_tree(mutated["batch_stats"]), stats,
                         1e-4, 1e-6, "batch_stats")
