"""The port's counterparts of the JAX package's small public functions:
the AoS wrappers ``points_in_tets`` and ``occupancy_from_grid``,
``latest_step``, ``face_valid_mask`` and ``load_vgg16_params``, each
against the JAX function on the same inputs.  Indices, labels and masks
exactly; the VGG state bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.nn import disn_port as jax_disn_port
from deftet_tpu.ops.point_tet import points_in_tets as jax_points_in_tets
from deftet_tpu.ops.voxelize import occupancy_from_grid as jax_occupancy
from deftet_tpu.tetgrid.lattice_faces import face_valid_mask as jax_mask
from deftet_tpu.train.checkpoint import latest_step as jax_latest_step
from deftet_tpu_torch.convert import flax_to_state_dict
from deftet_tpu_torch.nn.disn import VGG16Features, vgg_widths
from deftet_tpu_torch.nn.disn_port import (
    load_vgg16_params,
    load_vgg16_state_dict,
    vgg16_state_dict,
)
from deftet_tpu_torch.ops import occupancy_from_grid, points_in_tets
from deftet_tpu_torch.ops.point_tet import points_in_tets_soa
from deftet_tpu_torch.tetgrid import build_tet_grid, face_valid_mask
from deftet_tpu_torch.train import latest_step, save_checkpoint


def test_points_in_tets_matches_reference():
    """A res-3 grid deformed per batch element, queries inside and outside
    it: the first containing tet (or -1) equal to the JAX function's, and
    to the port's SoA form; no gradient flows."""
    rng = np.random.default_rng(3)
    grid = build_tet_grid(3)
    verts = grid.centered_vertices().astype(np.float32)
    pos = verts[None] + rng.normal(0.0, 0.02, (2,) + verts.shape).astype(
        np.float32)
    corners = pos[:, grid.tets]                      # (B, T, 4, 3)
    queries = rng.uniform(-0.6, 0.6, (2, 500, 3)).astype(np.float32)
    ref = np.asarray(jax_points_in_tets(jnp.asarray(corners),
                                        jnp.asarray(queries), chunk=16,
                                        query_chunk=128))
    t = torch.tensor(corners, requires_grad=True)
    got = points_in_tets(t, torch.tensor(queries), chunk=16, query_chunk=128)
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).any() and (ref == -1).any()
    soa = [[t.detach()[:, :, k, c] for c in range(3)] for k in range(4)]
    np.testing.assert_array_equal(
        points_in_tets_soa(soa, torch.tensor(queries)).numpy(), ref)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_occupancy_from_grid_matches_reference(threshold):
    """A random texture read at random points (inside and beyond the
    grid's extent): {0, 1} labels equal to the JAX function's."""
    rng = np.random.default_rng(4)
    occ = rng.uniform(size=(2, 16, 16, 16)).astype(np.float32)
    pts = rng.uniform(-0.7, 0.7, (2, 400, 3)).astype(np.float32)
    ref = np.asarray(jax_occupancy(jnp.asarray(occ), jnp.asarray(pts),
                                   threshold=threshold))
    got = occupancy_from_grid(torch.tensor(occ),
                              torch.tensor(pts, requires_grad=True),
                              threshold=threshold)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


def test_latest_step(tmp_path):
    """The largest integer-named checkpoint; None for a missing or empty
    directory; ``last``, ``best`` and temporary files are not steps.  The
    JAX function reads orbax directories named by step, the port's files
    ``{step}.pt``: both agree on the same steps in their own layouts."""
    assert latest_step(str(tmp_path / "missing")) is None
    assert jax_latest_step(str(tmp_path / "missing")) is None
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    assert latest_step(str(port_dir)) is None
    assert jax_latest_step(str(jax_dir)) is None
    for name in ("3", "12", "last", "best"):
        save_checkpoint(str(port_dir), name, {"step": name})
        (jax_dir / name).mkdir()
    (port_dir / "40.pt.123.tmp").write_bytes(b"")
    (port_dir / "7.tmp").write_bytes(b"")
    assert latest_step(str(port_dir)) == 12 == jax_latest_step(str(jax_dir))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_face_valid_mask_matches_reference(r):
    got = face_valid_mask(r)
    ref = jax_mask(r)
    assert got.dtype == ref.dtype == bool and got.shape == (12, r, r, r)
    np.testing.assert_array_equal(got, ref)


def _synthetic_vgg(width=0.05, classes=64):
    """A torchvision VGG-16 state dict (its keys) at a width-scaled size."""
    convs, hidden = vgg_widths(width)
    ids = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    g = torch.Generator().manual_seed(1)
    state, c_in = {}, 3
    for tid, c_out in zip(ids, convs):
        state[f"features.{tid}.weight"] = torch.randn((c_out, c_in, 3, 3),
                                                      generator=g)
        state[f"features.{tid}.bias"] = torch.randn(c_out, generator=g)
        c_in = c_out
    for tid, (o, i) in zip((0, 3, 6), ((hidden, c_in * 49),
                                       (hidden, hidden), (classes, hidden))):
        state[f"classifier.{tid}.weight"] = torch.randn((o, i), generator=g)
        state[f"classifier.{tid}.bias"] = torch.randn(o, generator=g)
    return state


def test_load_vgg16_params_matches_reference(tmp_path):
    """The port's ``load_vgg16_params`` is the loader path's state dict,
    and each JAX name (``load_vgg16_params``' flax tree, through the
    converter) lands on the same port name with the same values."""
    path = tmp_path / "vgg16.pth"
    torch.save(_synthetic_vgg(), path)
    got = load_vgg16_params(str(path))
    want = vgg16_state_dict(load_vgg16_state_dict(str(path)))
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    vgg = VGG16Features(num_classes=64, width=0.05)
    assert set(got) == set(vgg.state_dict())
    converted = flax_to_state_dict(
        {"params": jax_disn_port.load_vgg16_params(str(path))}, vgg)
    for key, value in converted.items():
        assert torch.equal(got[key], value), key
