"""The lap refinement layer as a whole: the port's ``decode_pos`` and
``forward_losses`` (every loss term, every parameter gradient, the
BatchNorm statistics) against the JAX package's on the small
configuration, float32, with and without remat; and the bf16 step's
counted-rounding check extended to the lap head.  The step checks here
also serve the DISN configurations (test_torch_disn_step,
test_torch_disn_lap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_step as ts
import torch_parity as tp
from deftet_tpu.evals.harness import adjacency_for
from deftet_tpu.losses import surface as jax_surface
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu_torch import remat
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.losses import surface as port_surface
from deftet_tpu_torch.nn.gcn import LatticeAdjacency
from deftet_tpu_torch.train import Engine

class _Float32Fields:
    """jax.numpy with bfloat16 read as float32, for the JAX package's
    surface-loss module."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def float32_normal_fields(mp):
    """Both packages' normal term with its per-face normal fields in
    float32.  Both scatter and slice-sum them in bf16; here the positions
    differ by float32 sums taken in another order (VGG convolutions, the
    lap head: ~1e-7), which moves a few of those fields across a bf16
    rounding boundary: the normal term then moves by ~1e-4 and, through
    its bf16 cotangents, the position path's gradients by ~2^-8 of its
    share.  With the fields in float32 the two agree within 5e-6.  The bf16
    fields themselves are held bit for bit on the point path
    (test_torch_step) and by the bf16 lap test below."""
    mp.setattr(jax_surface, "jnp", _Float32Fields())
    mp.setattr(port_surface, "NORMAL_FIELD_DTYPE", torch.float32)


# the three configurations of the slice: the point path with the lap
# layer, DISN, DISN with the lap layer
CONFIGS = {
    "lap": dict(use_lap_layer=True),
    "disn": dict(tp.DISN_TINY),
    "disn_lap": dict(tp.DISN_TINY, use_lap_layer=True),
}


def _setup(**over):
    # noise off and occ_sample >= n_tets (arange centers): the only draws
    # left are the chamfer barycentrics, injected below
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6, **over)
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    lattice = dict(
        lattice_offsets=jax_statics.lattice_offsets(grid),
        tet_lattice=jax_statics.lattice_tet_offsets(grid),
        face_lattice=jax_fl(grid),
    )
    return jcfg, cfg, jstat, model, variables, lattice


def _bary(jcfg, rng):
    """The JAX step's own barycentric draws (its fourth key)."""
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    shape = (jcfg.batch_size, jcfg.resolved_max_boundary_faces(),
             jcfg.per_face_samples, 1)
    return {"bary_u": torch.tensor(np.asarray(jax.random.uniform(ku, shape))),
            "bary_v": torch.tensor(np.asarray(jax.random.uniform(kv, shape)))}


@pytest.fixture(scope="module")
def reference():
    return step_reference("lap")


def step_reference(name):
    """The JAX package's step on one configuration: terms, gradients and
    updated BatchNorm statistics."""
    jcfg, cfg, jstat, model, variables, lattice = _setup(**CONFIGS[name])
    batch = tp.batch(cfg)
    rng = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jax_forward_losses(
            model, {"params": p,
                    "batch_stats": variables.get("batch_stats", {})},
            jbatch, jstat, jcfg, rng, train=True, **lattice)

    with pytest.MonkeyPatch.context() as mp:
        float32_normal_fields(mp)
        (total, (terms, mutated)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return dict(name=name, cfg=cfg, batch=batch,
                variables=variables, draws=_bary(jcfg, rng),
                total=float(total),
                terms={k: float(v) for k, v in terms.items()},
                grads=tp.numpy_tree(grads),
                stats=tp.numpy_tree(mutated.get("batch_stats", {})))


def _port_step(ref, remat_on):
    with pytest.MonkeyPatch.context() as mp:
        float32_normal_fields(mp)
        return _port_step_unpatched(ref, remat_on)


def _port_step_unpatched(ref, remat_on):
    engine = Engine(ref["cfg"], device="cpu")
    load_flax_variables(engine.model, tp.numpy_tree(ref["variables"]))
    params = dict(engine.model.named_parameters())
    batch = engine._prep_batch(ref["batch"])
    if remat_on:
        with remat.segmented(engine.generator):
            total, terms = engine.forward_losses(batch, draws=ref["draws"])
    else:
        total, terms = engine.forward_losses(batch, draws=ref["draws"])
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    return engine, total, terms, dict(zip(params, grads))


def assert_grads_close_in_norm(ref: dict, got: dict, rtol, atol):
    """Per leaf ||got - ref|| <= rtol ||ref|| + atol sqrt(n)."""
    flat = {".".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    for key, want in flat.items():
        err = float(np.linalg.norm(got[key] - want))
        bound = rtol * float(np.linalg.norm(want)) + atol * want.size**0.5
        assert err <= bound, f"grad {key}: |diff| {err} > {bound}"


def check_step(ref, remat_on):
    """Every loss term within rtol 1e-4 and every parameter gradient within
    rtol 1e-3 (atol 1e-5 for the biases feeding a BatchNorm, whose exact
    gradient is 0), with and without remat; the BatchNorm statistics.

    On the DISN configurations the gradients are held per leaf in norm:
    their 512-wide decoders have ReLU inputs down to 1e-8, inside the
    float32 difference of the two forwards (~1e-7: the VGG convolutions
    sum in another order), so a ReLU can switch for one point and move a
    single entry by ~1e-3 of the leaf's largest."""
    engine, total, terms, grads = _port_step(ref, remat_on)
    terms = {k: float(v.detach()) for k, v in terms.items()}
    assert set(terms) == set(ref["terms"])
    for name, value in ref["terms"].items():
        np.testing.assert_allclose(terms[name], value, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(float(total.detach()), ref["total"],
                               rtol=1e-4, atol=1e-6)
    got = tp.flax_layout(engine.model, grads)
    assert len(got) == len(jax.tree_util.tree_leaves(ref["grads"]))
    if ref["cfg"].use_disn:
        assert_grads_close_in_norm(ref["grads"], got, 1e-3, 1e-5)
    else:
        tp.assert_tree_close(ref["grads"], got, 1e-3, 1e-5, "grad")
    stats = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    tp.assert_tree_close(ref["stats"], stats, 1e-4, 1e-6, "batch_stats")


def check_remat(ref):
    """remat=True recomputes each segment exactly: the same gradients as
    remat=False, bit for bit on the CPU."""
    _, t0, _, g0 = _port_step(ref, False)
    _, t1, _, g1 = _port_step(ref, True)
    assert torch.equal(t0, t1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name


@pytest.mark.parametrize("remat_on", [False, True])
def test_step_matches_reference(reference, remat_on):
    """The res-4 step with the lap layer against the JAX package's."""
    check_step(reference, remat_on)


def test_remat_gradients_equal_none(reference):
    check_remat(reference)


def test_decode_pos_with_lap_layer_matches_reference():
    """decode_pos alone with the lap layer, float32: the total delta, the
    refined positions and the first head's raw output."""
    jcfg, cfg, jstat, model, variables, lattice = _setup(use_lap_layer=True)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.4, 0.4, (2, cfg.n_point, 3)).astype(np.float32)
    init = np.broadcast_to(np.asarray(jstat.init_pos_nx3)[None],
                           (2,) + jstat.init_pos_nx3.shape)
    mask = np.broadcast_to(np.asarray(jstat.pos_mask_nx3)[None], init.shape)
    adj, _ = adjacency_for(jstat, jcfg, lattice["lattice_offsets"])

    def run(v):
        pyr, _ = model.apply(v, jnp.asarray(pts), train=False,
                             method=model.encode)
        return model.apply(v, jnp.asarray(init), pyr, jnp.asarray(mask),
                           train=False, adj=adj, lattice_res=jcfg.res,
                           method=model.decode_pos)

    ref = jax.jit(run)(variables)
    net = tp.port_model(cfg, variables).eval()
    pstat = Engine(cfg, device="cpu").statics
    padj = LatticeAdjacency.from_degree(lattice["lattice_offsets"],
                                        pstat.vert_degree)
    with torch.no_grad():
        pyr, _ = net.encode(torch.tensor(pts), False)
        got = net.decode_pos(torch.tensor(init), pyr, torch.tensor(mask),
                             False, padj, cfg.res)
    for what, a, b in zip(("delta", "pos", "ori_delta"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=what)
    # the lap head moved the positions beyond the first head's delta
    assert not np.allclose(got[0].numpy(), got[2].numpy())


@pytest.fixture(scope="module")
def bf16_lap_reference():
    return ts.bf16_reference_for(use_lap_layer=True)


@pytest.mark.parametrize("fault", [None, "zeroed_lap_head_bias",
                                   "gcn_float32"])
def test_forward_losses_bf16_lap_match_reference(bf16_lap_reference, fault):
    """The bf16 step with the lap layer against the JAX package's, held by
    the counted-rounding tolerances of test_torch_step (the lap head's
    counts there), and two planted faults that must fail: a zeroed lap
    head-bias gradient and the GCN blocks computing in float32."""
    ref = bf16_lap_reference
    bad = ts._bf16_failures(ref, ts._port_bf16(ref, fault),
                            ref["cfg"].iou_logit_threshold)
    if fault is None:
        assert not bad, bad
    elif fault == "zeroed_lap_head_bias":
        assert set(bad) == {"lap_decoder_pos.head.bias"}, bad
    else:
        assert any("GraphConvBlock" in k for k in bad), bad
