"""K3 triangle argmin: the port's plain version against the Pallas kernel
(interpret mode), including all-masked batches, the chunk skip past the
last unmasked face and ties across the kernel's face chunks.  The CUDA
kernel is held against the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.ops.tri_distance import (
    point_to_mesh_squared_distance as jax_p2m,
)
from deftet_tpu.ops.tri_distance import (
    point_triangle_squared_distance as jax_pt_d2,
)
from deftet_tpu.ops.tri_distance_pallas import tri_argmin_pallas
from deftet_tpu_torch.ops import tri_distance


def _inputs(seed, b, p, f, keep=0.7):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    tri = rng.uniform(-1, 1, (b, f, 3, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, f)) < keep).astype(np.float32)
    return pts, tri, mask


def _d2_at(pts, tri, idx):
    sel = np.take_along_axis(tri, idx[:, :, None, None].astype(np.int64), 1)
    return np.asarray(jax_pt_d2(jnp.asarray(pts), jnp.asarray(sel[..., 0, :]),
                                jnp.asarray(sel[..., 1, :]),
                                jnp.asarray(sel[..., 2, :])))


def _compare(pts, tri, mask, **pallas_kw):
    ref = np.asarray(tri_argmin_pallas(jnp.asarray(pts), jnp.asarray(tri),
                                       jnp.asarray(mask), interpret=True,
                                       **pallas_kw))
    got = tri_distance.tri_argmin(torch.tensor(pts), torch.tensor(tri),
                                  torch.tensor(mask)).numpy()
    d_ref, d_got = _d2_at(pts, tri, ref), _d2_at(pts, tri, got)
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-4, atol=1e-6)
    # indices must agree wherever the best two faces are not near-tied
    full = np.where(mask[:, None, :] > 0, np.asarray(jax.vmap(
        lambda p, t: jax_pt_d2(p[:, None], t[None, :, 0], t[None, :, 1],
                               t[None, :, 2]))(jnp.asarray(pts),
                                               jnp.asarray(tri))), np.inf)
    two = np.sort(full, axis=-1)[..., :2]
    gap = np.where(np.isfinite(two[..., 1]),
                   two[..., 1] - np.where(np.isfinite(two[..., 0]),
                                          two[..., 0], 0.0), 0.0)
    clear = gap > 1e-5 * np.maximum(two[..., 0], 1e-6)
    np.testing.assert_array_equal(got[clear], ref[clear])
    return got, ref


def test_plain_tri_argmin_matches_pallas():
    pts, tri, mask = _inputs(6, 2, 300, 200)
    _compare(pts, tri, mask, tile_p=128, f_chunk=64)


def test_plain_tri_argmin_all_masked_and_chunk_skip():
    pts, tri, mask = _inputs(10, 2, 90, 300, keep=1.0)
    mask[0, 70:] = 0.0   # only the first 70 faces are real: chunks skipped
    mask[1, :] = 0.0     # every face masked: index 0
    got, _ = _compare(pts, tri, mask, tile_p=64, f_chunk=64)
    assert (got[1] == 0).all()
    assert (got[0] < 70).all()
    assert tri_distance.active_face_count(torch.tensor(mask)).tolist() == [
        70, 0]


def test_point_to_mesh_matches_reference_value_and_grad():
    pts, tri, mask = _inputs(12, 2, 64, 40)
    mask[1] = 0.0

    def jax_loss(p, t):
        d2, _ = jax_p2m(p, t, jnp.asarray(mask))
        return jnp.sum(jnp.sqrt(d2 + 1e-10))

    g_ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(pts),
                                               jnp.asarray(tri))
    pt = torch.tensor(pts, requires_grad=True)
    tt = torch.tensor(tri, requires_grad=True)
    d2, _ = tri_distance.point_to_mesh_squared_distance(pt, tt,
                                                        torch.tensor(mask))
    assert (d2[1] == 0).all()
    torch.sqrt(d2 + 1e-10).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(g_ref[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_ref[1]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("split", [7, 32, 100])
def test_split_merge_equals_whole_range_argmin(split):
    """The Pallas kernel scans the faces in chunks of ``split`` and merges
    them; the plain whole-range argmin must pick the same faces.  Faces
    are duplicated across every chunk boundary with points on them (an
    exact tie that the lowest index must win), one batch is masked with an
    n_active that is not a multiple of the chunk, one is all masked."""
    rng = np.random.default_rng(split)
    b, p, f = 3, 150, 300
    centers = rng.uniform(-1, 1, (b, f, 1, 3))
    tri = (centers + rng.uniform(-0.05, 0.05, (b, f, 3, 3))).astype(
        np.float32)
    pts = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    mask = np.ones((b, f), np.float32)
    mask[1] = rng.uniform(size=f) < 0.7
    mask[1, 257:] = 0.0
    mask[2] = 0.0
    bounds = list(range(split, f, split))
    for k, e in enumerate(bounds):
        tri[:, e] = tri[:, e - 1]
        pts[:, k % p] = tri[:, e].mean(axis=1)
    n_active = tri_distance.active_face_count(torch.tensor(mask))
    assert n_active.tolist() == [f, int(np.nonzero(mask[1])[0][-1]) + 1, 0]
    got, ref = _compare(pts, tri, mask, tile_p=128, f_chunk=split)
    assert (got[2] == 0).all()
    for k, e in enumerate(bounds[:p]):  # a point on a duplicated face
        assert got[0, k] == ref[0, k] == e - 1
