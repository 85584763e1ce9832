"""K1 lattice stencil: the port's plain version against the Pallas kernel
(interpret mode), value and gradient.  The CUDA kernel is held against
the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.ops.stencil_pallas import lattice_neighbor_mean as jax_lnm
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.train.statics import lattice_offsets as jax_offsets
from deftet_tpu_torch.ops import stencil
from deftet_tpu_torch.tetgrid import build_tet_grid
from deftet_tpu_torch.tetgrid.topology import vertex_degree
from deftet_tpu_torch.train.statics import lattice_offsets


def _lattice(res):
    grid = build_tet_grid(res)
    offs = lattice_offsets(grid)
    deg = vertex_degree(grid.tets, grid.n_vertices)
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

