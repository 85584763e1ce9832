"""Squeeze-excitation in the PVCNN encoder (``with_se``) against flax.

* float32: ``PVCNNEncoder(with_se=True)`` at a narrow width on converted
  flax variables, in train mode (with its updated running statistics) and
  in eval mode: the voxel pyramid and every parameter's gradient at rtol
  1e-5, with an atol of 1e-5 times the largest magnitude of each array
  (entries near 0 have no relative scale of their own; the biases whose
  exact gradient is 0 take the model's largest gradient as their scale).
* bfloat16: ``SE3d`` alone against flax on the same bf16 input, as
  tests/test_torch_modules.py holds one layer: the output equal bit for
  bit except where a bf16 rounding boundary lies within the float32 sums'
  error bound of the exact value.  The gradients are held in norm, within
  2^-5 of each array's norm: XLA:CPU sums the gate's bf16 cotangent over
  the voxels in bf16 (each partial sum rounded), the port in float32
  rounded once, the divergence ROADMAP.md records for bias gradients.
  The sigmoid is JAX's lowering, ``1 / (1 + exp(-x))`` rounded at each
  op (``nn.layers.sigmoid``).
* ``with_se=False`` leaves the encoder's state-dict keys as they were.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.nn.pvcnn import PVCNNEncoder as JaxEncoder
from deftet_tpu.nn.pvcnn import SE3d as JaxSE
from deftet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from deftet_tpu_torch.nn.layers import Dense
from deftet_tpu_torch.nn.pvcnn import PVCNNEncoder, SE3d

BLOCKS = ((8, 1, 8), (16, 1, 4))
RTOL = 1e-5
U32 = 2.0**-24


def _variables(enc, n_points, seed):
    """flax variables of ``enc`` drawn from a seed, of the shapes its init
    gives (traced, not compiled): LeCun-scaled kernels, and non-trivial
    biases, BatchNorm scales and statistics (the initial 1 / 0 would hide
    a layout slip)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k, x: enc.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, n_points, 3)))

    def draw(name, shape):
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * rng.uniform(size=shape)
        return 0.1 * rng.normal(size=shape)

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else
                np.asarray(draw(k, v.shape), np.float32)
                for k, v in tree.items()}

    return walk(shapes)


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.45, 0.45, (2, 256, 3)).astype(np.float32)
    jenc = JaxEncoder(blocks=BLOCKS, with_se=True)
    variables = _variables(jenc, pts.shape[1], seed=1)
    port = PVCNNEncoder(BLOCKS, with_se=True)
    load_flax_variables(port, variables)
    return pts, jenc, variables, port


def _close(got, ref, what, scale=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    atol = 1e-5 * (float(np.abs(ref).max()) if scale is None else scale)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_encoder_with_se_f32(encoders, train):
    pts, jenc, variables, port = encoders
    rng = np.random.default_rng(5)
    shapes = [(2, r, r, r, c) for c, _, r in BLOCKS]
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def loss(params, x):
        out = jenc.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, x,
                         train=train,
                         mutable=["batch_stats"] if train else False)
        pyramid, stats = out if train else (out, None)
        total = sum(jnp.sum(v * jnp.asarray(c))
                    for v, c in zip(pyramid, cots))
        return total, (pyramid, stats)

    (_, (pyramid, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"],
                                                jnp.asarray(pts))

    model = PVCNNEncoder(BLOCKS, with_se=True)
    model.load_state_dict(port.state_dict())
    model.zero_grad()
    got = model(torch.tensor(pts), train)
    sum((v * torch.tensor(c)).sum() for v, c in zip(got, cots)).backward()
    for i, (g, r) in enumerate(zip(got, pyramid)):
        _close(g.detach().numpy(), r, f"pyramid {i}")
    if train:
        ref_stats = flax_to_state_dict(
            {"batch_stats": jax.device_get(stats["batch_stats"]),
             "params": variables["params"]}, model)
        for name, buf in model.named_buffers():
            _close(buf.numpy(), ref_stats[name].numpy(), name)
    ref_grads = flax_to_state_dict(
        {"params": jax.device_get(grads),
         "batch_stats": variables["batch_stats"]}, model)
    names = [n for n, _ in model.named_parameters()]
    assert sum("SE3d_0.Dense_" in n for n in names) == 4
    # the biases that feed a train-mode BatchNorm have an exact gradient
    # of 0 (float32 noise on both sides): their atol is 1e-5 times the
    # model's largest gradient; the last block's point MLP is never read
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in model.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        null = train and name.endswith(("Conv_0.bias", "Conv_1.bias",
                                        "SharedMLP_0.Dense_0.bias"))
        _close(grad.numpy(), ref_grads[name].numpy(), name,
               scale if null else None)


def _sum_err(m):
    """Bound on a float32 sum's error over m terms, per unit sum|terms|
    (tests/test_torch_modules.py)."""
    return min(m, 6 * m**0.5) * U32


def _may_round_apart(v, delta):
    pad = delta + U32 * v.abs()
    return (v - pad).to(torch.bfloat16) != (v + pad).to(torch.bfloat16)


def _se_bf16(seed, x_mean):
    """The port's and flax's bf16 SE3d (B 8, r 4, C 16) on one bf16 input
    of mean ``x_mean``, a float32 loss sum(y * cot): (layer, x, the
    port's y and gradients, flax's y and gradients)."""
    rng = np.random.default_rng(seed)
    b, r, c = 8, 4, 16
    x = torch.tensor(rng.normal(x_mean, 1.0, size=(b, r, r, r, c)),
                     dtype=torch.float32).to(torch.bfloat16)
    cot = torch.tensor(rng.normal(size=(b, r, r, r, c)),
                       dtype=torch.float32).to(torch.bfloat16).float()
    layer = SE3d(c, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(seed))
    params = {f"Dense_{i}": {"kernel": jnp.asarray(
        getattr(layer, f"Dense_{i}").weight.detach().numpy().T)}
        for i in range(2)}
    assert set(layer.state_dict()) == {"Dense_0.weight", "Dense_1.weight"}
    flax_se = JaxSE(c, dtype=jnp.bfloat16)

    def loss(p, xj):
        y = flax_se.apply({"params": p}, xj)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot.numpy())), y
    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    compiled = step.lower(params, xj).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (_, ry), (rp, rdx) = compiled(params, xj)
    ref = [np.asarray(ry.astype(jnp.float32)),
           np.asarray(rdx.astype(jnp.float32))] + [
        np.asarray(rp[f"Dense_{i}"]["kernel"]).T for i in range(2)]

    xg = x.clone().requires_grad_(True)
    y = layer(xg)
    (y.float() * cot).sum().backward()
    got = [y.detach().float().numpy(), xg.grad.float().numpy()] + [
        getattr(layer, f"Dense_{i}").weight.grad.numpy() for i in range(2)]
    return layer, x, got, ref


def test_se3d_bf16_forward_rounds_as_flax():
    """Bit for bit at every gate (b, c) that cannot round apart.  A gate
    may where any voxel mean of its element (a float32 sum of r^3 terms)
    or hidden unit (a C-term product) may, or its own C/8-term product,
    or its exp (a float32 exp in either library, within 2 ulp; the add and
    the division then round alike).  Voxel values around 1 keep the means
    away from 0, where bf16's spacing is finer than the sums' error."""
    layer, x, (y, _, _, _), (ry, _, _, _) = _se_bf16(21, 1.0)
    r, c = x.shape[1], x.shape[-1]
    with torch.no_grad():
        x64 = x.double()
        pooled = x64.mean((1, 2, 3))
        may_b = _may_round_apart(pooled, _sum_err(r**3) * x64.abs().mean(
            (1, 2, 3))).any(1)
        pb = pooled.to(torch.bfloat16)
        w0 = layer.Dense_0.weight.to(torch.bfloat16).double()
        may_b |= _may_round_apart(pb.double() @ w0.T, _sum_err(c) * (
            pb.double().abs() @ w0.abs().T)).any(1)
        hr = torch.relu(layer.Dense_0(pb))
        w1 = layer.Dense_1.weight.to(torch.bfloat16).double()
        may = may_b[:, None] | _may_round_apart(
            hr.double() @ w1.T, _sum_err(c // 8) * (
                hr.double().abs() @ w1.abs().T))
        e = torch.exp(-layer.Dense_1(hr).double())
        may |= _may_round_apart(e, 4 * U32 * e)
    assert may.float().mean() < 0.5, may
    decided = ~may.numpy()
    np.testing.assert_array_equal(y.transpose(0, 4, 1, 2, 3)[decided],
                                  ry.transpose(0, 4, 1, 2, 3)[decided])


def test_se3d_bf16_gradients_near_flax():
    """The input's and both kernels' gradients, each within 2^-5 of its
    norm (observed: ~1e-3 for the input, 1-2e-2 for the kernels).  XLA:CPU
    sums the gate's bf16 cotangent over the r^3 voxels in bf16, each
    partial sum rounded (relative error up to ~r^3 2^-9); the port sums
    in float32 and rounds once."""
    _, _, got, ref = _se_bf16(22, 0.0)
    for what, g, r in zip(("dx", "Dense_0", "Dense_1"), got[1:], ref[1:]):
        err = np.linalg.norm(np.float64(g) - np.float64(r))
        assert err <= 2.0**-5 * np.linalg.norm(np.float64(r)), (what, err)


def test_without_se_the_state_dict_is_unchanged():
    """No SE3d entry and no new key: the keys are exactly those a flax
    encoder without SE converts to, and a bias-free Dense registers no
    bias."""
    port = PVCNNEncoder(BLOCKS)
    converted = flax_to_state_dict(
        _variables(JaxEncoder(blocks=BLOCKS), 16, seed=0), port)
    assert list(converted) == list(port.state_dict()) or \
        sorted(converted) == sorted(port.state_dict())
    assert not any("SE3d" in k for k in port.state_dict())
    assert all(getattr(port, f"PVConv_{i}").SE3d_0 is None
               for i in range(port.n))
    assert set(Dense(4, 2).state_dict()) == {"weight", "bias"}
    bare = Dense(4, 2, use_bias=False)
    assert set(bare.state_dict()) == {"weight"} and bare.bias is None
    x = torch.randn(3, 4)
    torch.testing.assert_close(bare(x), x @ bare.weight.T, rtol=0, atol=0)
