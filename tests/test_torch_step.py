"""The slice as a whole: the port's statics, ``forward_losses`` (every loss
term, every parameter gradient and the updated BatchNorm statistics) and
optimizer against the JAX package, on the small configuration."""

import functools
import math

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from deftet_tpu.ops import nearest as jax_nearest
from deftet_tpu.ops import nearest_pallas, stencil_pallas
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid.lattice_faces import face_lattice_info as jax_fl
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.train.step import forward_losses as jax_forward_losses
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.nn.layers import Conv3d, Dense
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


# ---- bf16 step parity -------------------------------------------------
#
# bf16 keeps 8 significant bits: rounding to nearest moves a value by at
# most U_BF16 = 2^-8 of itself.  The port rounds the JAX package's bf16
# expressions at the same places (the bias added after the product is
# rounded, the leaky-relu slope in bf16, BatchNorm's two float32
# conversions of its input).  The tolerances come from a model of the
# roundings: each is an independent relative error, uniform on
# [-U_BF16, U_BF16] (variance U_BF16^2 / 3), on each side.  Two
# computations that round r times on a value's path, each at places of
# its own, then differ by sqrt(2r/3) U_BF16 of the value (RMS).  Two that
# round at the same places differ less: their roundings agree except where
# a float32 sum taken in another order moves a value across a rounding
# boundary.  So the port is held within that independent-rounding RMS,
# which a port that rounds elsewhere, or not at all, reaches.  Over a leaf
# of n values, the relative norm of the difference is held to lambda_n
# times the RMS, lambda_n^2 the 0.999 quantile of chi^2_n / n.
#
# r counts the bf16 roundings whose input can differ between the two
# sides (parameters are equal on both, so their casts do not count).
# Forward: a product, a bias add, a BatchNorm output, a leaky-relu
# product, a stencil mean, the sum of two branches, a float32 activation
# cast to bf16.  Backward: a float32 cotangent cast to bf16, a transposed
# product, a BatchNorm (two parts rounded apart, then their sum: 2), a
# leaky-relu product, a stencil, the sum of two branches' cotangents.
#
# Forward, for the test's network (PVConv blocks 8,1,8;16,1,4, one GCN
# block 64 wide): PVConv_0's voxel path 9 (cast, conv and bias 2,
# BatchNorm, leaky, conv 2, BatchNorm, leaky), its point MLP 4; PVConv_1
# 9 more on the fused float32 features: 18 at the pyramid.  Positions:
# cast and initial layer 21, GCN layer 0 (stencil, product and bias,
# sum) 25, layer 1 29, shortcut 30, Dense_0 32, BatchNorm 33, head 35.
# Occupancy: cast and Dense_0 21, BatchNorm 22, Dense_1 24, BatchNorm 25,
# classifier 27.  A loss term's r is its input's; a gradient's is its
# loss's forward count plus the backward roundings down to the leaf.
U_BF16 = 2.0**-8
F_LOSS_POS, F_LOSS_OCC = 35, 27
# forward roundings at each BatchNorm's input (its running statistics)
F_BN_IN = {
    "PVConv_0.BatchNorm_0": 3, "PVConv_0.BatchNorm_1": 7,
    "PVConv_0.SharedMLP_0.BatchNorm_0": 3, "PVConv_1.BatchNorm_0": 12,
    "PVConv_1.BatchNorm_1": 16, "PVConv_1.SharedMLP_0.BatchNorm_0": 12,
    "decoder_pos.BatchNorm_0": 32, "decoder_occ.BatchNorm_0": 21,
    "decoder_occ.BatchNorm_1": 24,
}
# backward roundings from the loss to each layer's output.  Positions:
# head 1 (the cast), its BatchNorm 2 (product), Dense_0 4 (BatchNorm),
# GCN layer 1 5 (product), layer 0 8 (product, stencil, sum), initial
# layer 12 (product, stencil, sum, shortcut sum), 13 into the pyramid.
# Occupancy: classifier 1, BatchNorm_1 2, Dense_1 4, BatchNorm_0 5,
# Dense_0 7, 8 into the pyramid.  Encoders (pyramid cotangents float32,
# 13): PVConv_1 BatchNorm_1 15 (cast, leaky), Conv_1 17, BatchNorm_0 19
# (product, leaky), Conv_0 21, 22 into the fused features; PVConv_0
# BatchNorm_1 24, Conv_1 26, BatchNorm_0 28, Conv_0 30, its point MLP's
# BatchNorm 23 (cast) and Dense 25.
B_OUT = {
    "decoder_pos.head": 1, "decoder_pos.BatchNorm_0": 2,
    "decoder_pos.Dense_0": 4,
    "decoder_pos.GraphConvBlock_0.GraphConvLayer_1": 5,
    "decoder_pos.GraphConvBlock_0.GraphConvLayer_0": 8,
    "decoder_pos.initial": 12,
    "decoder_occ.classifier": 1, "decoder_occ.BatchNorm_1": 2,
    "decoder_occ.Dense_1": 4, "decoder_occ.BatchNorm_0": 5,
    "decoder_occ.Dense_0": 7,
    "PVConv_1.BatchNorm_1": 15, "PVConv_1.Conv_1": 17,
    "PVConv_1.BatchNorm_0": 19, "PVConv_1.Conv_0": 21,
    "PVConv_0.BatchNorm_1": 24, "PVConv_0.Conv_1": 26,
    "PVConv_0.BatchNorm_0": 28, "PVConv_0.Conv_0": 30,
    "PVConv_0.SharedMLP_0.BatchNorm_0": 23,
    "PVConv_0.SharedMLP_0.Dense_0": 25,
}


# With the lap layer (test_torch_lap) the refinement head is a second GCN
# head of the same widths on the probe ++ the refined positions: its own
# counts equal the first head's (positions, like the occupancy decoder's
# centers, count as the pyramid's input).  Backward, the first head's
# output also gets the cotangent of the lap head's input: 12 roundings to
# the lap head's initial layer and its product into the positions, 13,
# before the first head's own; so every count from the first head's
# output down (the first head and the encoders) grows by 13.
LAP_INPUT_B = 13


def rounding_tables(lap: bool):
    """(F_LOSS_POS, F_LOSS_OCC, F_BN_IN, B_OUT) of the test's network,
    with or without the lap head."""
    if not lap:
        return F_LOSS_POS, F_LOSS_OCC, F_BN_IN, B_OUT
    f_bn = dict(F_BN_IN)
    f_bn["lap_decoder_pos.BatchNorm_0"] = F_BN_IN["decoder_pos.BatchNorm_0"]
    b_out = {}
    for key, r in B_OUT.items():
        if key.startswith("decoder_pos."):
            b_out["lap_" + key] = r
        b_out[key] = r if key.startswith("decoder_occ.") else \
            r + LAP_INPUT_B
    return F_LOSS_POS, F_LOSS_OCC, f_bn, b_out


def _lookup(table, module):
    """The entry of ``table`` whose key starts the module path (the two
    encoders share their entries)."""
    module = module.removeprefix("encoder_pos.").removeprefix("encoder_occ.")
    hits = [k for k in table if module == k or module.startswith(k + ".")]
    assert len(hits) == 1, module
    return table[hits[0]]


def _lambda(n):
    """sqrt of the 0.999 quantile of chi^2_n / n (Wilson-Hilferty)."""
    z = 3.090  # the standard normal's 0.999 quantile
    return (1 - 2 / (9 * n) + z * math.sqrt(2 / (9 * n))) ** 1.5


def _rounding_tol(n, r):
    """Relative norm within which n values r roundings deep must agree."""
    return _lambda(n) * math.sqrt(2 * r / 3) * U_BF16


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_chain(rows):
    """rows[0] + rows[1] + ... from 0, each partial sum a float32 add of
    two bf16 values rounded to bf16 (XLA's bf16 add)."""
    acc = np.zeros(rows.shape[1:], np.float32)
    for row in rows:
        acc = _bf16(acc + row)
    return acc


def _xla_bias_sum(g):
    """A bias gradient as the reference computes it on XLA:CPU: the bf16
    cotangent g of the layer's output summed in bf16 (the transpose of
    the bias broadcast, with excess precision off).  XLA:CPU's
    tree-reduction rewrite pads a reduced point axis longer than 32 to a
    multiple of 32 (half the pad below, rounded down) and sums it in
    windows of 32 points times the batch, row-major, each window a chain
    from 0, then chains the windows; a convolution's four reduced axes
    (none longer than 32) are one row-major chain."""
    c = g.shape[-1]
    if g.ndim == 3 and g.shape[1] > 32:
        b, n, _ = g.shape
        pad = -n % 32
        padded = np.zeros((b, n + pad, c), np.float32)
        padded[:, pad // 2:pad // 2 + n] = g
        w = (n + pad) // 32
        windows = padded.reshape(b, w, 32, c).transpose(1, 0, 2, 3)
        return _bf16_chain(_bf16_chain(
            windows.reshape(w, b * 32, c).transpose(1, 0, 2)))
    return _bf16_chain(g.reshape(-1, c))


def _pallas_reference(mp):
    """The JAX package's GCN neighbour mean and chamfer nearest neighbour
    through their Pallas kernels in interpret mode, the ops K1 and K2 port.
    On the CPU the package otherwise runs a depthwise conv that rounds the
    neighbour sum to bf16 and then divides it by the bf16 degree, where
    the kernel (and the port) scales in float32 and rounds once."""
    mp.setattr(jax_nearest, "_use_pallas_auto", lambda: True)
    mp.setattr(nearest_pallas, "nearest_neighbor_pallas",
               functools.partial(nearest_pallas.nearest_neighbor_pallas,
                                 interpret=True))
    mean = stencil_pallas.lattice_neighbor_mean
    mp.setattr(stencil_pallas, "lattice_neighbor_mean",
               lambda x, inv_deg, n, offsets, interpret=True: mean(
                   x, inv_deg, n, offsets, True))


def _flat(tree):
    return {".".join(p.key for p in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tp.numpy_tree(tree))[0]}


@pytest.fixture(scope="module")
def bf16_reference():
    return bf16_reference_for()


def bf16_reference_for(**over):
    """The JAX package's bf16 step at res 4 (compiled without excess
    precision, so it rounds as written): terms, gradients, BatchNorm
    statistics, and the cotangent of every Dense / Conv output, read as
    the gradient of an exact zero added to it (which changes only the
    order of a few float32 sums); with the rounding counts of its
    network."""
    jcfg, cfg = tp.configs(add_input_noise=False, occ_sample=10**6,
                           precision="bf16", gcn_hidden="64,64", **over)
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat)
    lattice = dict(
        lattice_offsets=jax_statics.lattice_offsets(grid),
        tet_lattice=jax_statics.lattice_tet_offsets(grid),
        face_lattice=jax_fl(grid),
    )
    batch = tp.batch(cfg)
    rng = jax.random.PRNGKey(3)
    ku, kv = jax.random.split(jax.random.split(rng, 4)[3])
    shape = (cfg.batch_size, jcfg.resolved_max_boundary_faces(),
             cfg.per_face_samples, 1)
    draws = {"bary_u": np.asarray(jax.random.uniform(ku, shape)),
             "bary_v": np.asarray(jax.random.uniform(kv, shape))}
    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}

    def layers(zeros=None, shapes=None):
        def add(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__" and isinstance(
                    context.module, (flax_nn.Dense, flax_nn.Conv)):
                key = ".".join(context.module.path)
                if shapes is not None:
                    assert key not in shapes, f"{key} runs twice"
                    shapes[key] = jax.ShapeDtypeStruct(out.shape, out.dtype)
                else:
                    out = out + zeros[key]
            return out
        return flax_nn.intercept_methods(add)

    def loss_fn(params, zeros):
        with layers(zeros):
            return jax_forward_losses(
                model, {"params": params,
                        "batch_stats": variables["batch_stats"]},
                jbatch, jstat, jcfg, rng, train=True, **lattice)

    with pytest.MonkeyPatch.context() as mp:
        _pallas_reference(mp)
        shapes = {}
        with layers(shapes=shapes):
            jax.eval_shape(lambda p: jax_forward_losses(
                model, {"params": p, "batch_stats": variables["batch_stats"]},
                jbatch, jstat, jcfg, rng, train=True, **lattice),
                variables["params"])
        zeros = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
        step = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)
        compiled = jax.jit(step).lower(variables["params"], zeros).compile(
            compiler_options={"xla_allow_excess_precision": False})
        (total, (terms, mutated)), (grads, cots) = compiled(
            variables["params"], zeros)
    return dict(
        cfg=cfg, variables=variables, batch=batch, draws=draws,
        tables=rounding_tables(cfg.use_lap_layer),
        total=float(total), terms={k: float(v) for k, v in terms.items()},
        grads=_flat(grads), stats=_flat(mutated["batch_stats"]),
        cots={k: np.asarray(v.astype(jnp.float32)) for k, v in cots.items()})


def _port_bf16(ref, fault):
    """The port's bf16 step on the reference's inputs: terms, total,
    gradients, BatchNorm statistics, the occupancy logits and each Dense /
    Conv output's cotangent, all in the flax layout; ``fault`` plants a
    known fault."""
    engine = Engine(ref["cfg"], device="cpu")
    assert engine.model.decoder_pos.initial.dtype == torch.bfloat16
    load_flax_variables(engine.model, tp.numpy_tree(ref["variables"]))
    if fault == "gcn_float32":
        for name, module in engine.model.named_modules():
            if "GraphConvBlock" in name and hasattr(module, "dtype"):
                module.dtype = None
    cots, logits = {}, []

    def hook(name):
        def keep(module, args, y):
            if y.requires_grad:
                y.register_hook(lambda g: cots.__setitem__(
                    f"{name}.bias", g.float()))
        return keep

    for name, module in engine.model.named_modules():
        if isinstance(module, (Dense, Conv3d)):
            module.register_forward_hook(hook(name))
    engine.model.decoder_occ.register_forward_hook(
        lambda m, a, y: logits.append(y.detach()[..., 0]))
    draws = {k: torch.tensor(v) for k, v in ref["draws"].items()}
    total, terms = engine.forward_losses(engine._prep_batch(ref["batch"]),
                                         train=True, draws=draws)
    params = dict(engine.model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    got = tp.flax_layout(engine.model, dict(zip(params, grads)))
    if fault in ("zeroed_head_bias", "zeroed_lap_head_bias"):
        key = ("lap_" if fault == "zeroed_lap_head_bias" else "") + \
            "decoder_pos.head.bias"
        got[key] = np.zeros_like(got[key])
    stats = tp.flax_layout(engine.model, dict(engine.model.named_buffers()))
    cots = {k.removesuffix(".bias"): v for k, v in
            tp.flax_layout(engine.model, cots).items()}
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in terms.items()}, got, stats,
            cots, logits[0])


def _bf16_failures(ref, port, logit_threshold):
    """{what: (measured, bound)} for every value outside its bound."""
    total, terms, got, stats, cots, logit = port
    f_loss_pos, f_loss_occ, f_bn_in, b_out = ref["tables"]
    bad = {}

    def f_loss(module):
        return f_loss_occ if module.startswith("decoder_occ") else f_loss_pos

    def hold(what, a, b, r, atol=0.0):
        err = float(np.linalg.norm(np.asarray(a) - np.asarray(b)))
        bound = _rounding_tol(np.size(b), r) * float(np.linalg.norm(b)) + atol
        if not err <= bound:
            bad[what] = (err, bound)

    # loss terms (atol 1e-6 as in the float32 test: the volume variance
    # is ~1e-14, a difference of near-equal volumes)
    assert set(terms) == set(ref["terms"])
    for name, value in ref["terms"].items():
        if name != "occ_iou":
            hold(name, terms[name], value,
                 f_loss_occ if name == "occ" else f_loss_pos, atol=1e-6)
    hold("total", total, ref["total"], f_loss_pos, atol=1e-6)
    # occupancy IoU counts logits above the threshold: only a logit within
    # the logits' tolerance of it can change sides; each flip moves the
    # intersection and the union by one
    near = int(((logit - logit_threshold).abs() <= _rounding_tol(
        1, f_loss_occ) * logit.abs().max()).sum())
    union = max(int((logit >= logit_threshold).sum()) - near, 1)
    if not abs(terms["occ_iou"] - ref["terms"]["occ_iou"]) <= \
            2 * near / union:
        bad["occ_iou"] = (terms["occ_iou"], ref["terms"]["occ_iou"])

    # the cotangent of every layer's output, then its bias.  got - ref of
    # a bias is (got - sum g_port) + sum (g_port - g_ref) + (sum g_ref -
    # ref): the port's own reduction (a float32 sum, rounded once to
    # bf16), the cotangents' difference (held above), and the reference's
    # bf16 reduction, which _xla_bias_sum reproduces bit for bit
    assert len(got) == len(ref["grads"])
    for module, g_ref in ref["cots"].items():
        key = f"{module}.bias"
        if not np.any(g_ref):  # the last PVConv's unread point MLP
            assert module not in cots and not np.any(got[key]), module
            continue
        g = cots[module]
        hold(f"cotangent of {module}", g, g_ref,
             f_loss(module) + _lookup(b_out, module))
        assert np.array_equal(_xla_bias_sum(g_ref), ref["grads"][key]), key
        g = g.reshape(-1, g.shape[-1]).astype(np.float64)
        s = g.sum(0)
        bound = U_BF16 * np.abs(s) + (1 + U_BF16) * len(g) * 2.0**-24 * \
            np.abs(g).sum(0)
        err = np.abs(got[key] - s)
        if not np.all(err <= bound):
            bad[key] = (float(err.max()), float(bound.min()))
    # the kernels (their own product the last rounding) and BatchNorm's
    # scale and bias (float32 from the cotangent and the normalized input)
    for key, ref_leaf in ref["grads"].items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "bias" and module in ref["cots"]:
            continue
        if not np.any(ref_leaf) and not np.any(got[key]):
            continue
        hold(key, got[key], ref_leaf, f_loss(module)
             + _lookup(b_out, module) + (leaf == "kernel"))
    # the running statistics: float32 means of bf16 activations
    for key, ref_leaf in ref["stats"].items():
        hold(key, stats[key], ref_leaf,
             _lookup(f_bn_in, key.rsplit(".", 1)[0]))
    return bad


@pytest.mark.parametrize("fault", [None, "zeroed_head_bias", "gcn_float32"])
def test_forward_losses_bf16_match_reference(bf16_reference, fault):
    """The bf16 step at res 4 against the JAX package's, both rounding in
    bf16: every loss term, every layer's output cotangent, every
    parameter gradient and the BatchNorm statistics, at the tolerances
    above; and two planted faults that must fail, a zeroed head-bias
    gradient and the GCN blocks computing in float32.  The GCN is 64 wide
    so that each layer reaches the reference's stencil kernel (it takes
    the kernel from 64 channels)."""
    ref = bf16_reference
    bad = _bf16_failures(ref, _port_bf16(ref, fault),
                         ref["cfg"].iou_logit_threshold)
    if fault is None:
        assert not bad, bad
    elif fault == "zeroed_head_bias":
        assert set(bad) == {"decoder_pos.head.bias"}, bad
    else:
        assert any("GraphConvBlock" in k for k in bad), bad


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
