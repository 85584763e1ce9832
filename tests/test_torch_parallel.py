"""Data parallelism: an R-rank step of the port equals the port's
one-process step on the global batch, and the JAX package's step on a
2-device mesh.

One 3-rank gloo world on the CPU (a ``FileStore`` in a fresh directory:
the test workers run side by side, and fixed TCP ports would collide)
runs every case of this file once: at batch 2 and 4 the divisor clamp
puts the step on ranks 0 and 1, and rank 2 takes no part.  Tolerances:
against the one-process step, terms rtol 2e-4 / atol 1e-6 and gradients
rtol 2e-3 / atol 1e-5 (tests/test_train.py's sharded-against-single
contract); against JAX, those of the f32 step test
(test_torch_step.py)."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parity as tp
import torch_ranks
from deftet_tpu.losses import surface as jax_surface
from deftet_tpu.train import Engine as JaxEngine
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu_torch import parallel
from deftet_tpu_torch.convert import flax_to_state_dict
from deftet_tpu_torch.data import pipeline
from deftet_tpu_torch.nn import DeformableTetNetwork

TERMS = dict(rtol=2e-4, atol=1e-6)
GRADS = dict(rtol=2e-3, atol=1e-5)
# dropout in both decoders, the input noise and a random center subsample
DROPOUT = dict(occ_sample=64, occ_mlp_hidden="16,0.2,8",
               pos_mlp_hidden="8,0.3")


def _val_batch(root, n, n_samples=256):
    """A global validation batch with SDF samples, from a dataset of
    ``n`` procedural shapes (padded to one face count)."""
    paths = pipeline.build_dataset(root, n_shapes=n, n_surface=n_samples,
                                   n_sdf=n_samples, seed=3, level=1,
                                   num_workers=1, occ_grid_res=16)
    return next(pipeline.batch_iterator(pipeline.ShapeDataset(paths), n))


class _Float32Fields:
    """jax.numpy with bfloat16 read as float32, for the JAX package's
    surface-loss module (see test_torch_lap.float32_normal_fields: both
    packages scatter the normal term's face fields in bf16, and a 1e-7
    position difference moves some across a rounding boundary)."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def _jax_case(logdir):
    """The JAX engine on a 2-device data mesh with BatchNorm statistics
    jittered as tp.jax_variables does, and the port case holding its
    converted variables and its draws (noise off, every tet center: the
    barycentrics are the only draws)."""
    # the JAX engine creates its experiment directory at once
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6,
                           logdir=logdir)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    eng = JaxEngine(jcfg, mesh=mesh)
    rng = np.random.default_rng(100)

    def jitter(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
        if name in ("bias", "mean"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32)
        return x

    variables = jax.tree_util.tree_map_with_path(jitter, {
        "params": eng.state.params, "batch_stats": eng.state.batch_stats})
    batch = tp.batch(cfg, seed=4)
    key = jax.random.PRNGKey(9)
    ku, kv = jax.random.split(jax.random.split(key, 4)[3])
    shape = (jcfg.batch_size, jcfg.resolved_max_boundary_faces(),
             jcfg.per_face_samples, 1)
    draws = {"bary_u": torch.tensor(np.asarray(jax.random.uniform(ku, shape))),
             "bary_v": torch.tensor(np.asarray(jax.random.uniform(kv, shape)))}
    state = flax_to_state_dict(tp.numpy_tree(variables), _port_model(cfg))
    case = dict(config=vars(cfg), batch=batch,
                draws=draws, state=state, float32_normal_fields=True)
    return case, (eng, variables, batch, key)


def _jax_reference(eng, variables, batch, key):
    """Terms, gradients and updated statistics of the JAX forward on the
    engine's mesh (batch sharded, variables replicated)."""
    rep = NamedSharding(eng.mesh, P())
    params = jax.device_put(variables["params"], rep)
    bstats = jax.device_put(variables["batch_stats"], rep)
    sharded = eng._prep_batch(batch)
    assert len(sharded["surface_points"].sharding.device_set) == 2

    def loss_fn(p):
        total, (terms, mutated) = jax_forward_losses(
            eng.model, {"params": p, "batch_stats": bstats}, sharded,
            eng.statics, eng.config, key, train=True,
            lattice_offsets=eng._lattice_offsets,
            tet_lattice=eng._tet_lattice, face_lattice=eng._face_lattice)
        return total, (terms, mutated)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_surface, "jnp", _Float32Fields())
        (total, (terms, mutated)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    terms = {k: float(v) for k, v in terms.items()}
    terms["total"] = float(total)
    return {"terms": terms, "grads": tp.numpy_tree(grads),
            "batch_stats": tp.numpy_tree(mutated["batch_stats"])}


def _port_model(cfg):
    return DeformableTetNetwork(
        blocks=cfg.parsed_blocks(), gcn_hidden=cfg.parsed_gcn_hidden(),
        pos_mlp_hidden=cfg.parsed_pos_mlp_hidden(),
        occ_mlp_hidden=cfg.parsed_occ_mlp_hidden())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    _, cfg4 = tp.configs(batch_size=4, eval_points=200, **DROPOUT)
    base = {**vars(cfg4), "logdir": str(tmp / "logs")}
    batch4 = tp.batch(cfg4, seed=1)
    jax_case, jax_inputs = _jax_case(str(tmp / "logs"))
    cases = {
        "dropout": dict(config=base, batch=batch4,
                        val_batch=_val_batch(str(tmp / "data"), 4)),
        "accum": dict(config={**base, "grad_accum": 2}, batch=batch4,
                      restore=True),
        "remat": dict(config={**base, "grad_accum": 2, "remat": True},
                      batch=batch4),
        "fault": dict(config=base, batch=batch4, fault=True),
        "jax": jax_case,
    }
    # the ranks run in their own processes while JAX compiles here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.run_ranks, torch_ranks.parity_ranks, 3,
                            cases, device="cpu")
        jax_ref = _jax_reference(*jax_inputs)
        single = {name: torch_ranks.run_case(case)
                  for name, case in cases.items() if name != "fault"}
        ranks = ranks.result()
    return cases, ranks, single, jax_ref


def _assert_step_close(got, ref):
    assert set(got["terms"]) == set(ref["terms"])
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, err_msg=k, **TERMS)
    assert len(got["grads"]) == len(ref["grads"])
    for i, (g, r) in enumerate(zip(got["grads"], ref["grads"])):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=f"grad {i}",
                                   **GRADS)


@pytest.mark.parametrize("name", ["dropout", "accum", "remat"])
def test_two_rank_step_equals_one_process(runs, name):
    _, ranks, single, _ = runs
    for rank in (0, 1):
        _assert_step_close(ranks[rank][name], single[name])
    # BatchNorm's running statistics come from the global statistics:
    # equal on both ranks, and the one process's
    for k, v in single[name]["buffers"].items():
        np.testing.assert_array_equal(ranks[0][name]["buffers"][k].numpy(),
                                      ranks[1][name]["buffers"][k].numpy())
        np.testing.assert_allclose(ranks[0][name]["buffers"][k].numpy(),
                                   v.numpy(), err_msg=k, **TERMS)
    # the gradient and terms are reduced: every rank holds the same
    for a, b in zip(ranks[0][name]["grads"], ranks[1][name]["grads"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ranks[0][name]["terms"] == ranks[1][name]["terms"]


@pytest.mark.parametrize("kind", ["val", "val_inference"])
def test_two_rank_validation_equals_one_process(runs, kind):
    _, ranks, single, _ = runs
    ref = single["dropout"][kind]
    assert ref and set(ranks[0]["dropout"][kind]) == set(ref)
    for rank in (0, 1):
        for k, v in ref.items():
            np.testing.assert_allclose(ranks[rank]["dropout"][kind][k], v,
                                       err_msg=k, **TERMS)


def test_batchnorm_without_all_reduce_fails(runs):
    _, ranks, single, _ = runs
    with pytest.raises(AssertionError):
        _assert_step_close(ranks[0]["fault"], single["dropout"])


def test_rank_past_the_divisor_takes_no_part(runs):
    cases, ranks, _, _ = runs
    assert parallel.largest_divisor(3, 2) == 2
    assert parallel.largest_divisor(3, 4) == 2
    assert cases["jax"]["config"]["batch_size"] == 2
    assert all(r is None for r in ranks[2].values())
    assert all(r is not None for r in ranks[0].values())


def test_two_rank_step_equals_jax_two_device_mesh(runs):
    cases, ranks, single, ref = runs
    cfg = cases["jax"]["config"]
    model = _port_model(tp.configs()[1])
    names = [n for n, _ in model.named_parameters()]
    for got in (single["jax"], ranks[0]["jax"], ranks[1]["jax"]):
        assert set(got["terms"]) == set(ref["terms"])
        for k, v in ref["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        grads = tp.flax_layout(model, dict(zip(names, got["grads"])))
        tp.assert_tree_close(ref["grads"], grads, 1e-3, 1e-5, "grad")
        stats = tp.flax_layout(model, got["buffers"])
        tp.assert_tree_close(ref["batch_stats"], stats, 1e-4, 1e-6,
                             "batch_stats")
    assert cfg["add_input_noise"] is False


def test_shard_rows_is_microbatch_major():
    x = np.arange(8)
    assert parallel.shard_rows({"x": x}, 1, 2)["x"].tolist() == [4, 5, 6, 7]
    # microbatches of 4 rows: rank 1 takes rows 2-3 of each
    got = parallel.shard_rows({"x": x, "l": list(x)}, 1, 2, microbatches=2)
    assert got["x"].tolist() == [2, 3, 6, 7] and got["l"] == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="grad_accum=2"):
        parallel.shard_rows({"x": np.arange(6)}, 0, 2, microbatches=2)


def test_engine_refuses_a_microbatch_that_does_not_split():
    # batch 4 in 4 microbatches of 1 row cannot split over 2 ranks; the
    # Engine refuses before any collective
    world = parallel.World(rank=0, size=2, local_rank=0,
                           device=torch.device("cpu"), backend="gloo")
    _, cfg = tp.configs(batch_size=4, grad_accum=4)
    with pytest.raises(ValueError, match="grad_accum=4"):
        torch_ranks.Engine(cfg, world=world)


def test_restore_broadcasts_rank_0s_checkpoint(runs):
    _, ranks, single, _ = runs
    assert single["accum"]["restored"]
    assert ranks[0]["accum"]["restored"] and ranks[1]["accum"]["restored"]
