"""The port's PointNet sampling ops, PointNet modules and frustum losses
against the JAX package, on tests/test_sampling.py's cases (whose numpy
oracles of the reference CUDA kernels also hold the indices): FPS and
ball-query indices equal exactly, gathers and 3-NN values and gradients
at rtol 1e-5, ``logits_mask`` equal with the priorities injected, the
modules after conversion at rtol 1e-4 (outputs) and 1e-3 (gradients),
the frustum loss and its gradients at rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu.losses import frustum as jax_frustum
from deftet_tpu.nn import pointnet as jax_pointnet
from deftet_tpu.ops import sampling as jax_sampling
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.losses import frustum
from deftet_tpu_torch.nn import pointnet
from deftet_tpu_torch.ops import sampling
from test_sampling import _np_ball_query, _np_fps


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", ["oracle", "clusters", "wide"])
def test_fps_indices_equal(case):
    if case == "oracle":
        coords = np.random.default_rng(0).normal(size=(2, 64, 3))
        m = 16
    elif case == "clusters":
        rng = np.random.default_rng(1)
        coords = np.concatenate([rng.normal(size=(32, 3)) * 0.01,
                                 rng.normal(size=(32, 3)) * 0.01 + 10.0])[None]
        m = 2
    else:
        coords = np.random.default_rng(8).uniform(-1, 1, (2, 2048, 3))
        m = 128
    coords = coords.astype(np.float32)
    got = sampling.furthest_point_sample(_t(coords), m).numpy()
    ref = np.asarray(jax_sampling.furthest_point_sample(jnp.asarray(coords),
                                                        m))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    for b in range(coords.shape[0]):
        np.testing.assert_array_equal(got[b], _np_fps(coords[b], m))


@pytest.mark.parametrize("case", ["oracle", "empty", "wide"])
def test_ball_query_indices_equal(case):
    if case == "oracle":
        rng = np.random.default_rng(2)
        points = rng.uniform(-1, 1, (2, 40, 3))
        centers = rng.uniform(-1, 1, (2, 7, 3))
        radius, u = 0.7, 5
    elif case == "empty":
        points, centers = np.ones((1, 8, 3)), -np.ones((1, 2, 3)) * 100.0
        radius, u = 0.1, 4
    else:
        rng = np.random.default_rng(9)
        points = rng.uniform(-1, 1, (2, 1024, 3))
        centers = points[:, :64] + rng.normal(0, 0.05, (2, 64, 3))
        radius, u = 0.2, 32
    points, centers = points.astype(np.float32), centers.astype(np.float32)
    got = sampling.ball_query(_t(centers), _t(points), radius, u).numpy()
    ref = np.asarray(jax_sampling.ball_query(jnp.asarray(centers),
                                             jnp.asarray(points), radius, u))
    np.testing.assert_array_equal(got, ref)
    for b in range(points.shape[0]):
        np.testing.assert_array_equal(
            got[b], _np_ball_query(centers[b], points[b], radius, u))


def test_gather_and_grouping_values_and_gradients():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 10, 4)).astype(np.float32)
    idx3 = np.array([[[0, 3], [9, 9], [2, 5]], [[1, 1], [4, 0], [7, 8]]],
                    np.int32)
    idx2 = idx3.reshape(2, 6)
    w = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)

    def jax_loss(f):
        g = jax_sampling.grouping(f, jnp.asarray(idx3))
        p = jax_sampling.gather_points(f, jnp.asarray(idx2))
        return jnp.sum(g * w) + jnp.sum(p * p)

    ref_g = jax_sampling.grouping(jnp.asarray(feats), jnp.asarray(idx3))
    ref_p = jax_sampling.gather_points(jnp.asarray(feats), jnp.asarray(idx2))
    ref_grad = jax.grad(jax_loss)(jnp.asarray(feats))
    f = _t(feats, grad=True)
    g = sampling.grouping(f, _t(idx3))
    p = sampling.gather_points(f, _t(idx2))
    (torch.sum(g * _t(w)) + torch.sum(p * p)).backward()
    _close(g, ref_g)
    _close(p, ref_p)
    _close(f.grad, ref_grad)


@pytest.mark.parametrize("case", ["oracle", "at_centers", "wide"])
def test_three_nn_interpolate_values_and_gradients(case):
    rng = np.random.default_rng(4)
    if case == "oracle":
        points = rng.uniform(-1, 1, (2, 20, 3))
        centers = rng.uniform(-1, 1, (2, 6, 3))
        cfeat = rng.normal(size=(2, 6, 5))
    elif case == "at_centers":
        centers = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]]])
        points, cfeat = centers, np.eye(4)[None]
    else:
        points = rng.uniform(-1, 1, (2, 1024, 3))
        centers = rng.uniform(-1, 1, (2, 128, 3))
        cfeat = rng.normal(size=(2, 128, 16))
    points, centers, cfeat = (a.astype(np.float32)
                              for a in (points, centers, cfeat))

    def jax_loss(p, c, f):
        return jnp.sum(jax_sampling.three_nn_interpolate(p, c, f) ** 2)

    args = tuple(jnp.asarray(a) for a in (points, centers, cfeat))
    # eager, op by op: under jit XLA fuses the expanded distance into
    # other roundings, which the weights (~1/d) amplify past 1e-5
    ref = jax_sampling.three_nn_interpolate(*args)
    ref_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*args)
    tp_, tc, tf = (_t(a, grad=True) for a in (points, centers, cfeat))
    out = sampling.three_nn_interpolate(tp_, tc, tf)
    torch.sum(out ** 2).backward()
    _close(out, ref)
    _close(tf.grad, ref_grads[2])
    # the gradient reaches the features only, in both packages
    assert tp_.grad is None and tc.grad is None
    assert float(jnp.abs(ref_grads[0]).max()) == 0.0


def test_logits_mask_equal_with_injected_priorities():
    rng = np.random.default_rng(5)
    n, m = 50, 12
    coords = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    logits = np.zeros((3, n, 2), np.float32)
    logits[0, :30, 1] = 1.0  # 30 candidates >= m: no repeats
    logits[1, :4, 1] = 1.0  # 4 candidates < m: wrap-repeat
    key = jax.random.PRNGKey(0)
    sel, mean, mask = jax_sampling.logits_mask(
        jnp.asarray(coords), jnp.asarray(logits), m, key)
    # logits_mask's own draw of its priorities (sampling.py:183)
    pri = np.asarray(jax.random.uniform(key, (3, n)))
    got = sampling.logits_mask(_t(coords), _t(logits), m, priorities=_t(pri))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(mask))
    # the same points picked in the same slots; the values then differ
    # only by the masked mean's sum order (an ulp)
    def picks(sel_b, mean_b, b):
        pool = coords[b] * np.asarray(mask)[b][:, None] - mean_b
        return np.abs(pool[None] - sel_b[:, None]).sum(-1).argmin(-1)

    for b in range(3):
        np.testing.assert_array_equal(
            picks(got[0].numpy()[b], got[1].numpy()[b], b),
            picks(np.asarray(sel)[b], np.asarray(mean)[b], b))
    _close(got[1], mean, rtol=1e-6, atol=1e-7)
    _close(got[0], sel, rtol=1e-6, atol=1e-7)
    # the generator's draw gives a valid selection of the same candidates
    own = sampling.logits_mask(_t(coords), _t(logits), m,
                               generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(own[2].numpy(), np.asarray(mask))


def _module_pairs():
    """(flax module, its init args, port module, forward kwargs) for the
    three PointNet modules at test_sampling.py's sizes."""
    rng = jax.random.PRNGKey(0)
    b, n, c = 2, 64, 8
    coords = jax.random.uniform(rng, (b, n, 3), minval=-1, maxval=1)
    feats = jax.random.normal(rng, (b, n, c))
    sa_kw = dict(num_centers=16, radius=[0.4, 0.8], num_neighbors=[8, 16],
                 out_channels=[[16, 32], [16, 32]])
    centers = jax.random.uniform(jax.random.PRNGKey(1), (b, 16, 3),
                                 minval=-1, maxval=1)
    cfeat = jax.random.normal(jax.random.PRNGKey(2), (b, 16, 64))
    return {
        "sa": (jax_pointnet.PointNetSAModule(**sa_kw), (feats, coords),
               pointnet.PointNetSAModule(c, **sa_kw)),
        "fp": (jax_pointnet.PointNetFPModule(out_channels=[32, 16]),
               (coords, centers, cfeat, feats),
               pointnet.PointNetFPModule(64 + c, [32, 16])),
        "a": (jax_pointnet.PointNetAModule(out_channels=[32, 64]),
              (feats, coords), pointnet.PointNetAModule(c, [32, 64])),
    }


@pytest.mark.parametrize("name", ["sa", "fp", "a"])
def test_pointnet_modules_after_conversion(name):
    jmod, args, pmod = _module_pairs()[name]
    variables = jax.jit(lambda k, *a: jmod.init(k, *a, train=False))(
        jax.random.PRNGKey(3), *args)
    variables = tp.numpy_tree(variables)
    # non-trivial BatchNorm parameters (the initial ones would hide a
    # layout slip)
    rng = np.random.default_rng(6)

    def jitter(path, x):
        if path[-1].key in ("scale",):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if path[-1].key in ("bias",):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    variables = jax.tree_util.tree_map_with_path(jitter, variables)
    load_flax_variables(pmod, variables)
    w = jnp.asarray(np.random.default_rng(7).normal(
        size=jax.eval_shape(lambda: jmod.apply(
            variables, *args, train=True,
            mutable=["batch_stats"])[0][0]).shape).astype(np.float32))

    # a mean: the Dense biases before a BatchNorm have an exact gradient
    # of 0, and their rounding noise scales with the loss
    def jax_loss(params, *a):
        (out, _), mutated = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *a,
            train=True, mutable=["batch_stats"])
        return jnp.mean(out * w), (out, mutated)

    argnums = (0,) + tuple(i + 1 for i, a in enumerate(args)
                           if a.shape[-1] != 3)
    grads, (out_ref, mutated) = jax.jit(jax.grad(
        jax_loss, argnums=argnums, has_aux=True))(variables["params"], *args)
    targs = [_t(a, grad=a.shape[-1] != 3) for a in args]
    out, coords_out = pmod(*targs, train=True)
    torch.mean(out * _t(w)).backward()
    _close(out, out_ref, rtol=1e-4, atol=1e-5, msg="output")
    params = dict(pmod.named_parameters())
    got = tp.flax_layout(pmod, {k: p.grad for k, p in params.items()})
    tp.assert_tree_close(tp.numpy_tree(grads[0]), got, 1e-3, 1e-5, "grad")
    feats_grads = [t.grad for t in targs if t.requires_grad]
    for g, r in zip(feats_grads, grads[1:]):
        _close(g, r, rtol=1e-3, atol=1e-5, msg="input grad")
    stats = tp.flax_layout(pmod, dict(pmod.named_buffers()))
    tp.assert_tree_close(tp.numpy_tree(mutated["batch_stats"]), stats,
                         1e-4, 1e-6, "batch_stats")
    # evaluation mode reads the running statistics the step updated
    ref_out = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        {"params": variables["params"], **mutated}, *args)
    _close(pmod(*targs, train=False)[0], ref_out[0], rtol=1e-4, atol=1e-5)
    _close(coords_out, np.asarray(ref_out[1]))


def _frustum_inputs(b=5, nh=4, ns=3, n=10, seed=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    inputs = {
        "mask_logits": rng.normal(size=(b, n, 2)).astype(f),
        "center": rng.normal(size=(b, 3)).astype(f),
        "center_reg": rng.normal(size=(b, 3)).astype(f),
        "heading_scores": rng.normal(size=(b, nh)).astype(f),
        "heading_residuals_normalized": rng.normal(size=(b, nh)).astype(f),
        "heading_residuals": rng.normal(0, 0.3, (b, nh)).astype(f),
        "size_scores": rng.normal(size=(b, ns)).astype(f),
        "size_residuals_normalized": rng.normal(size=(b, ns, 3)).astype(f),
        "size_residuals": rng.normal(0, 0.3, (b, ns, 3)).astype(f),
    }
    targets = {
        "mask_logits": rng.integers(0, 2, (b, n)).astype(np.int32),
        "center": rng.normal(size=(b, 3)).astype(f),
        "heading_bin_id": rng.integers(0, nh, b).astype(np.int32),
        "heading_residual": rng.uniform(-0.3, 0.3, b).astype(f),
        "size_template_id": rng.integers(0, ns, b).astype(np.int32),
        "size_residual": rng.uniform(-0.2, 0.2, (b, 3)).astype(f),
    }
    templates = rng.uniform(0.5, 3.0, (ns, 3)).astype(f)
    return inputs, targets, templates


def test_frustum_loss_and_gradients():
    inputs, targets, templates = _frustum_inputs()
    nh, ns = inputs["heading_scores"].shape[1], templates.shape[0]
    ref_fn = jax_frustum.FrustumPointNetLoss(nh, ns, templates)
    loss_fn = frustum.FrustumPointNetLoss(nh, ns, templates)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    ref, ref_grads = jax.jit(jax.value_and_grad(lambda i: ref_fn(i, jt)))(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    ti = {k: _t(v, grad=True) for k, v in inputs.items()}
    got = loss_fn(ti, {k: _t(v) for k, v in targets.items()})
    got.backward()
    _close(got, ref, msg="loss")
    for k, v in ti.items():
        _close(v.grad, ref_grads[k], atol=1e-6, msg=k)
    # the box corners (with the flip) on their own
    c, h, s = (inputs["center"], targets["heading_residual"],
               np.abs(inputs["center_reg"]) + 0.5)
    for got_c, ref_c in zip(
            frustum.get_box_corners_3d(_t(c), _t(h), _t(s), with_flip=True),
            jax_frustum.get_box_corners_3d(jnp.asarray(c), jnp.asarray(h),
                                           jnp.asarray(s), with_flip=True)):
        _close(got_c, ref_c)


def test_kl_and_huber_losses_and_gradients():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    y = (x * 2.0 + rng.normal(0, 0.1, x.shape)).astype(np.float32)
    y[0, 0] = -200.0  # an entry whose softmax underflows
    ref, (gx_ref, gy_ref) = jax.value_and_grad(
        jax_frustum.kl_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, grad=True), _t(y, grad=True)
    got = frustum.kl_loss(tx, ty)
    got.backward()
    _close(got, ref)
    _close(ty.grad, gy_ref)
    assert tx.grad is None
    assert float(jnp.abs(gx_ref).max()) == 0.0
    err = rng.normal(0, 2.0, 64).astype(np.float32)
    ref, g_ref = jax.value_and_grad(jax_frustum.huber_loss)(
        jnp.asarray(err), 1.0)
    te = _t(err, grad=True)
    got = frustum.huber_loss(te, 1.0)
    got.backward()
    _close(got, ref)
    _close(te.grad, g_ref)
