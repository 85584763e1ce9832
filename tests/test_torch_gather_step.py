"""The gather paths as a whole, against the JAX package on the small
configuration in float32: ``forward_losses`` (every term, every parameter
gradient, the updated BatchNorm statistics) on a 1->8 split grid, at the
default budget and at budget 0 (the uncompacted surface path).  The
lattice at budget 0 is in test_torch_uncompacted, the split grid's
inference step and engine in test_torch_gather_eval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.train import Engine, statics

_EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    jgrid, pgrid = tp.split_grid(tmp_path_factory.mktemp("g") / "s.tet")
    jstat = jax_statics.build_grid_statics(4, grid=jgrid)
    return jstat, statics.build_grid_statics(4, grid=pgrid)


def _reference_step(jcfg, jstat, lattice, batch, rng):
    """The JAX step's terms, gradients and BatchNorm statistics, and its
    variables."""
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def value_and_grad(params):
        def loss_fn(p):
            return jax_forward_losses(
                model, {"params": p, "batch_stats": variables["batch_stats"]},
                jbatch, jstat, jcfg, rng, train=True, **lattice)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    compiled = jax.jit(value_and_grad).lower(variables["params"]).compile(
        compiler_options=_EXACT)
    (total, (terms, mutated)), grads = compiled(variables["params"])
    return variables, float(total), terms, grads, mutated["batch_stats"]


@pytest.mark.parametrize("case", ["split_default", "split_budget0"])
def test_forward_losses_match_reference(case, split):
    check_forward_losses(case, split)


def check_forward_losses(case, split=None):
    """The port's forward_losses with gradients against the JAX package's
    on ``case``: split_default, split_budget0 or lattice_budget0."""
    budget = -1 if case == "split_default" else 0
    # noise off and occ_sample >= n_tets (arange centers): the only draws
    # left are the chamfer barycentrics, injected below
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6,
                           max_boundary_faces=budget)
    if case.startswith("split"):
        jstat, pstat = split
        lattice = {}
    else:
        grid = jax_grid(jcfg.res)
        jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
        pstat = None
        lattice = dict(lattice_offsets=jax_statics.lattice_offsets(grid),
                       tet_lattice=jax_statics.lattice_tet_offsets(grid),
                       face_lattice=jax_fl(grid))
    batch = tp.batch(cfg)
    rng = jax.random.PRNGKey(3)
    variables, total_ref, terms_ref, grads_ref, stats_ref = _reference_step(
        jcfg, jstat, lattice, batch, rng)

    # the JAX step's own barycentric draws: over the compacted working set,
    # or over every face at budget 0
    n_faces = jstat.face_fx3.shape[0]
    k = budget if budget > 0 else jcfg.resolved_max_boundary_faces() or n_faces
    compacted = 0 < k < n_faces
    assert compacted == (case == "split_default")
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    shape = (cfg.batch_size, k, cfg.per_face_samples, 1)
    draws = {n: torch.tensor(np.asarray(jax.random.uniform(key, shape)))
             for n, key in (("bary_u", ku), ("bary_v", kv))}

    engine = Engine(cfg, device="cpu", statics=pstat)
    assert (engine.statics.lattice is None) == (pstat is not None)
    load_flax_variables(engine.model, tp.numpy_tree(variables))
    total, terms = engine.forward_losses(engine._prep_batch(batch),
                                         train=True, draws=draws)
    params = dict(engine.model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]

    terms = {n: float(v.detach()) for n, v in terms.items()}
    assert set(terms) == set(terms_ref)
    for name, ref in terms_ref.items():
        np.testing.assert_allclose(terms[name], float(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(total.detach()), total_ref, rtol=1e-4,
                               atol=1e-6)
    for name in ("surf_chamfer", "surface_align", "normal", "lap"):
        assert terms[name] > 0.0, name
    if not compacted:
        assert terms["boundary_overflow"] == 0.0
    got = tp.flax_layout(engine.model, dict(zip(params, grads)))
    assert len(got) == len(jax.tree_util.tree_leaves(grads_ref))
    tp.assert_tree_close(tp.numpy_tree(grads_ref), got, 1e-3, 1e-5, "grad")
    buffers = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    tp.assert_tree_close(tp.numpy_tree(stats_ref), buffers, 1e-4, 1e-6,
                         "batch_stats")
