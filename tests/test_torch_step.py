"""The slice as a whole: the port's statics, ``forward_losses`` (every loss
term, every parameter gradient and the updated BatchNorm statistics) and
optimizer against the JAX package, on the small configuration."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.tetgrid import build_tet_grid, face_lattice_info
from deftet_tpu_torch.train import Engine, statics
from deftet_tpu_torch.train.step import ClippedAdam


@pytest.fixture(scope="module")
def setup():
    # noise off and occ_sample >= n_tets (arange centers): the only draws
    # left are the chamfer barycentrics, which are injected below
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6)
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    lattice = dict(
        lattice_offsets=jax_statics.lattice_offsets(grid),
        tet_lattice=jax_statics.lattice_tet_offsets(grid),
        face_lattice=jax_fl(grid),
    )
    return jcfg, cfg, grid, jstat, model, variables, lattice


def test_statics_match_reference(setup):
    jcfg, _, grid, jstat, _, _, lattice = setup
    pgrid = build_tet_grid(jcfg.res)
    np.testing.assert_array_equal(pgrid.tets, grid.tets)
    got = statics.build_grid_statics(jcfg.res, grid=pgrid)
    for name in ("init_pos_nx3", "pos_mask_nx3", "tet_tx4", "face_fx3",
                 "vert_degree"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(jstat, name)),
            err_msg=name)
    np.testing.assert_allclose(got.rest_inverse_tx3x3.numpy(),
                               np.asarray(jstat.rest_inverse_tx3x3),
                               rtol=1e-6, atol=1e-6)
    assert statics.lattice_offsets(pgrid) == lattice["lattice_offsets"]
    assert statics.lattice_tet_offsets(pgrid) == lattice["tet_lattice"]
    fl, jfl = face_lattice_info(pgrid), lattice["face_lattice"]
    assert fl.res == jfl.res
    assert fl.edge_incidence == jfl.edge_incidence
    assert [vars(c) for c in fl.classes] == [vars(c) for c in jfl.classes]


def test_forward_losses_match_reference(setup):
    jcfg, cfg, grid, jstat, model, variables, lattice = setup
    batch = tp.batch(cfg)
    rng = jax.random.PRNGKey(3)
    # the JAX step's own barycentric draws (surface.py:85-87), injected
    # into the port so both sides sample the same points
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    k = jcfg.resolved_max_boundary_faces()
    assert k < 12 * jcfg.res**3  # compaction is active
    shape = (cfg.batch_size, k, cfg.per_face_samples, 1)
    bary_u = np.asarray(jax.random.uniform(ku, shape))
    bary_v = np.asarray(jax.random.uniform(kv, shape))

    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}

    def value_and_grad(params):
        def loss_fn(p):
            total, (terms, mutated) = jax_forward_losses(
                model, {"params": p, "batch_stats": variables["batch_stats"]},
                jbatch, jstat, jcfg, rng, train=True, **lattice)
            return total, (terms, mutated)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    # XLA would otherwise keep the normal loss's bf16 slice sums in f32
    # (excess precision); the JAX code, like the port, rounds each to bf16
    compiled = jax.jit(value_and_grad).lower(variables["params"]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (total_ref, (terms_ref, mutated)), grads_ref = compiled(
        variables["params"])

    engine = Engine(cfg, device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    draws = {"bary_u": torch.tensor(bary_u), "bary_v": torch.tensor(bary_v)}
    total, terms = engine.forward_losses(engine._prep_batch(batch),
                                         train=True, draws=draws)
    params = dict(engine.model.named_parameters())
    # the last PVConv's fused point features are never read, so its
    # point MLP has no gradient in either framework (zeros in JAX's)
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]

    terms = {k: float(v.detach()) for k, v in terms.items()}
    assert set(terms) == set(terms_ref)
    for name, ref in terms_ref.items():
        np.testing.assert_allclose(terms[name], float(ref),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(total.detach()), float(total_ref),
                               rtol=1e-4, atol=1e-6)
    assert terms["boundary_overflow"] == 0.0
    assert terms["surf_chamfer"] > 0.0 and terms["normal"] > 0.0

    # every parameter gradient (rtol 1e-3: backward sums run in another
    # order; atol 1e-5 covers the conv biases that feed a BatchNorm, whose
    # exact gradient is 0)
    got = tp.flax_layout(engine.model, dict(zip(params, grads)))
    assert len(got) == len(jax.tree_util.tree_leaves(grads_ref))
    tp.assert_tree_close(tp.numpy_tree(grads_ref), got, 1e-3, 1e-5, "grad")
    # the updated running statistics
    stats = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    tp.assert_tree_close(tp.numpy_tree(mutated["batch_stats"]), stats,
                         1e-4, 1e-6, "batch_stats")


@pytest.mark.parametrize("scale", [1.0, 1e3])  # below / above the clip norm
def test_optimizer_matches_optax(scale):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.normal(size=s)).astype(np.float32)
              for s in shapes] for _ in range(3)]

    tx = optax.chain(optax.clip_by_global_norm(40.0), optax.adam(1e-3))
    ref = [jnp.asarray(p) for p in params]
    state = tx.init(ref)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, upd)

    got = [torch.tensor(p) for p in params]
    opt = ClippedAdam(got, lr=1e-3, max_norm=40.0)
    for g in grads:
        opt.step([torch.tensor(x) for x in g])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_engine_train_steps_on_cpu():
    _, cfg = tp.configs(occ_sample=128)
    engine = Engine(cfg, device="cpu")
    batch = engine._prep_batch(tp.batch(cfg, seed=1))
    before = [p.detach().clone() for p in engine.model.parameters()]
    for _ in range(2):
        terms = engine.train_step(batch)
        for name, v in terms.items():
            assert torch.isfinite(v), name
    assert engine.global_step == 2
    moved = [not torch.equal(a, b)
             for a, b in zip(before, engine.model.parameters())]
    assert any(moved)


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = tp.configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
