"""K1 lattice stencil: the port's plain version against the Pallas kernel
(interpret mode), value and gradient, and the backward's in-kernel
cotangent pre-scale (``in_scale``) against the JAX package's separate
pre-scale pass, bit for bit in bf16.  The CUDA kernel is held against the
plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.ops.stencil_pallas import lattice_neighbor_mean as jax_lnm
from deftet_tpu.ops.stencil_pallas import stencil_sum as jax_stencil_sum
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.train.statics import lattice_offsets as jax_offsets
from deftet_tpu_torch.ops import stencil
from deftet_tpu_torch.tetgrid import build_tet_grid
from deftet_tpu_torch.tetgrid.topology import build_vertex_adjacency
from deftet_tpu_torch.train.statics import lattice_offsets


def _lattice(res):
    grid = build_tet_grid(res)
    offs = lattice_offsets(grid)
    deg = build_vertex_adjacency(grid.tets, grid.n_vertices)[2]
    inv_deg = (1.0 / np.maximum(deg, 1)).astype(np.float32)
    return grid.resolution + 1, offs, inv_deg


def test_port_offsets_match_reference():
    assert lattice_offsets(build_tet_grid(5)) == jax_offsets(jax_grid(5))


@pytest.mark.parametrize("channels", [3, 130])
def test_plain_stencil_matches_pallas(channels):
    n, offs, inv_deg = _lattice(4)
    rng = np.random.default_rng(channels)
    x = rng.normal(size=(2, n**3, channels)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jax_loss(a):
        return jnp.sum(jax_lnm(a, jnp.asarray(inv_deg), n, offs, True) * w)

    ref = jax_lnm(jnp.asarray(x), jnp.asarray(inv_deg), n, offs, True)
    g_ref = jax.grad(jax_loss)(jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    got = stencil.lattice_neighbor_mean(xt, torch.tensor(inv_deg), n, offs)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-6)


def test_plain_stencil_bf16_grad_dtype():
    n, offs, _ = _lattice(3)
    x = torch.tensor(
        np.random.default_rng(1).normal(size=(1, n**3, 64)),
        dtype=torch.bfloat16, requires_grad=True)
    inv_deg = torch.ones(n**3)
    out = stencil.lattice_neighbor_mean(x, inv_deg, n, offs)
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all()


def test_stencil_rejects_bad_input():
    n, offs, inv_deg = _lattice(3)
    with pytest.raises(ValueError):
        stencil.stencil_sum(torch.zeros(1, n**3 + 1, 4), n, offs)
    with pytest.raises(TypeError):
        stencil.stencil_sum(torch.zeros(1, n**3, 4, dtype=torch.float64),
                            n, offs)



def _bf16_pair(rng, shape):
    """The same bf16 values as a torch tensor and a JAX array."""
    t = torch.tensor(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("res,channels", [(3, 3), (4, 40), (4, 130)])
def test_in_scale_matches_jax_prescale_bitwise(res, channels):
    """stencil_sum_plain(g, in_scale=inv_deg) is the JAX backward's
    stencil_sum((g * inv_deg).astype(bf16)), bit for bit."""
    n, offs, inv_deg = _lattice(res)
    g_t, g_j = _bf16_pair(np.random.default_rng(res * 7 + channels),
                          (2, n**3, channels))
    pre = (g_j * jnp.asarray(inv_deg)[None, :, None]).astype(jnp.bfloat16)
    ref = jax_stencil_sum(pre, n, offs, interpret=True)
    got = stencil.stencil_sum_plain(g_t, n, offs,
                                    in_scale=torch.tensor(inv_deg))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("channels", [3, 64])
def test_bf16_value_and_grad_match_custom_vjp_bitwise(channels):
    """The port's lattice_neighbor_mean and its gradient in bf16 equal the
    JAX package's custom VJP (Pallas in interpret mode) bit for bit."""
    n, offs, inv_deg = _lattice(4)
    rng = np.random.default_rng(channels)
    x_t, x_j = _bf16_pair(rng, (2, n**3, channels))
    g_t, g_j = _bf16_pair(rng, (2, n**3, channels))
    y_j, vjp = jax.vjp(
        lambda a: jax_lnm(a, jnp.asarray(inv_deg), n, offs, True), x_j)
    (gx_j,) = vjp(g_j)

    xt = x_t.clone().requires_grad_()
    y_t = stencil.lattice_neighbor_mean(xt, torch.tensor(inv_deg), n, offs)
    (gx_t,) = torch.autograd.grad(y_t, xt, g_t)
    np.testing.assert_array_equal(y_t.detach().float().numpy(),
                                  np.asarray(y_j.astype(jnp.float32)))
    np.testing.assert_array_equal(gx_t.float().numpy(),
                                  np.asarray(gx_j.astype(jnp.float32)))


def test_backward_is_one_stencil_call_with_in_scale(monkeypatch):
    """StencilMean.backward hands the cotangent itself to one stencil_sum
    call with in_scale = inv_deg: no elementwise pass of its own."""
    n, offs, inv_deg = _lattice(3)
    calls = []
    real = stencil.stencil_sum

    def spy(x, n_, offsets, scale=None, in_scale=None):
        calls.append((x, scale, in_scale))
        return real(x, n_, offsets, scale, in_scale)

    monkeypatch.setattr(stencil, "stencil_sum", spy)
    inv = torch.tensor(inv_deg)
    x = torch.randn(1, n**3, 8, dtype=torch.bfloat16, requires_grad=True)
    y = stencil.lattice_neighbor_mean(x, inv, n, offs)
    g = torch.randn_like(y)
    calls.clear()
    torch.autograd.grad(y, x, g)
    assert len(calls) == 1
    x_in, scale, in_scale = calls[0]
    assert x_in.data_ptr() == g.data_ptr()
    assert scale is None and in_scale is inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_scale_with_out_scale_plain(dtype):
    """Both scales at once: the in_scale product is rounded to x's dtype
    before the sum, the out scale applied after it."""
    n, offs, inv_deg = _lattice(3)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, n**3, 5)), dtype=torch.float32
                     ).to(dtype)
    s_in = torch.tensor(rng.uniform(0.1, 2.0, n**3), dtype=torch.float32)
    s_out = torch.tensor(inv_deg)
    pre = (x.float() * s_in[None, :, None]).to(dtype)
    assert torch.equal(
        stencil.stencil_sum(x, n, offs, s_out, s_in),
        stencil.stencil_sum(pre, n, offs, s_out))
