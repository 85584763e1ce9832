"""The port's rasterizer (deftet_tpu_torch.render.raster) against the JAX
package's, on the CPU: the plain hit pass (the CUDA kernel's twin), the
binning helpers and the differentiable replay.

Tolerances: hit ids and counts equal; features rtol 1e-5 / atol 1e-6
(the two frameworks round the same f32 expressions in other orders);
gradients rtol 1e-4 / atol 1e-6 (sums of many such terms).  Inputs are
random, so no two faces tie in z: JAX's top-k leaves tie order open.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.render import raster as jr
from deftet_tpu_torch.render import raster as tr


def _random_scene(seed, f, p, spread=0.08):
    """Random triangles and random pixels (as tests/test_render.py), the
    triangles well shaped (corners at thirds of a turn around a centre,
    radius up to ``spread``) so that no gradient comes from a
    near-degenerate barycentric division."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (1, f, 1, 2))
    turn = (rng.uniform(0.0, 2 * np.pi, (1, f, 1))
            + np.arange(3) * 2 * np.pi / 3)
    radius = rng.uniform(0.25 * spread, spread, (1, f, 1, 1))
    img = (base + radius * np.stack([np.cos(turn), np.sin(turn)], -1)
           ).astype(np.float32)
    z = rng.uniform(-5.0, -1.0, (1, f, 3)).astype(np.float32)
    feat = rng.uniform(0.0, 1.0, (1, f, 3, 3)).astype(np.float32)
    pix = rng.uniform(-1.0, 1.0, (1, p, 2)).astype(np.float32)
    ranges = np.concatenate(
        [np.full((1, p, 1), -1000.0), np.zeros((1, p, 1))], axis=-1
    ).astype(np.float32)
    return pix, ranges, z, img, feat


def _tri_scene(z_vals, feats):
    """One big triangle per entry, all covering the origin pixel."""
    f = len(z_vals)
    img = np.tile(np.asarray([[[-1.0, -1.0], [3.0, -1.0], [-1.0, 3.0]]],
                             np.float32), (1, f, 1, 1))
    z = np.asarray([z_vals], np.float32)[..., None].repeat(3, axis=-1)
    feat = np.asarray([feats], np.float32)[:, :, None, :].repeat(3, axis=2)
    return z, img, feat


def _both(args, **kw):
    """(JAX (features, ids), port (features, ids)) as numpy."""
    jf, ji = jr.deftet_sparse_render(*map(jnp.asarray, args), **kw)
    tf, ti = tr.deftet_sparse_render(*map(torch.as_tensor, args), **kw)
    return (np.asarray(jf), np.asarray(ji)), (tf.numpy(), ti.numpy())


def test_barycentric_matches_jax():
    rng = np.random.default_rng(0)
    pix = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    tri = rng.uniform(-1, 1, (64, 3, 2)).astype(np.float32)
    tri[0] = tri[0, :1]  # a zero-area triangle takes the guarded divisor
    got = tr.barycentric_2d(torch.as_tensor(pix), torch.as_tensor(tri))
    want = jr.barycentric_2d(jnp.asarray(pix), jnp.asarray(tri))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["order_k2", "miss", "range", "interp"])
def test_hand_scenes_match_jax(case):
    ranges = np.asarray([[[-1000.0, 0.0]]], np.float32)
    pix = np.zeros((1, 1, 2), np.float32)
    k = 2
    if case == "order_k2":      # z -1 nearest, then -2; k=2 drops -3
        z, img, feat = _tri_scene([-3.0, -1.0, -2.0], [[3.0], [1.0], [2.0]])
    elif case == "miss":
        z, img, feat = _tri_scene([-1.0], [[5.0]])
        pix = np.asarray([[[10.0, 10.0]]], np.float32)
    elif case == "range":       # the range excludes z = -5
        z, img, feat = _tri_scene([-1.0, -5.0], [[1.0], [2.0]])
        ranges = np.asarray([[[-3.0, 0.0]]], np.float32)
    else:                       # feature = corner x, so interp = pixel x
        img = np.asarray([[[[-1.0, -1.0], [3.0, -1.0], [-1.0, 3.0]]]],
                         np.float32)
        z = np.full((1, 1, 3), -1.0, np.float32)
        feat = np.asarray([[[[-1.0], [3.0], [-1.0]]]], np.float32)
        pix = np.asarray([[[0.5, 0.0], [0.0, 0.5]]], np.float32)
        ranges = np.tile(ranges, (1, 2, 1))
        k = 1
    (jf, ji), (tf, ti) = _both((pix, ranges, z, img, feat), k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-6)
    if case == "order_k2":
        np.testing.assert_array_equal(ti[0, 0], [1, 2])


@pytest.mark.parametrize("mode", ["unbinned", "binned", "tiles"])
def test_sparse_render_and_gradients_match_jax(mode):
    pix, ranges, z, img, feat = _random_scene(1, f=300, p=200, spread=0.3)
    kw = dict(k=5, chunk=64)
    if mode == "binned":
        kw.update(pixel_chunk=64, bin_cand=256)
    elif mode == "tiles":   # the caller's order, consecutive 50-pixel tiles
        kw.update(pixel_chunk=50, bin_cand=200, bin_sort=False)
    (jf, ji), (tf, ti) = _both((pix, ranges, z, img, feat), **kw)
    np.testing.assert_array_equal(ti, ji)
    assert (ti >= 0).sum() > 100  # the scene really overlaps
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-6)

    w = np.random.default_rng(2).normal(size=jf.shape).astype(np.float32)

    def jloss(zz, ii, ff):
        layers, _ = jr.deftet_sparse_render(jnp.asarray(pix),
                                            jnp.asarray(ranges), zz, ii, ff,
                                            **kw)
        return jnp.sum(layers * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(img), jnp.asarray(feat))
    leaves = [torch.tensor(a, requires_grad=True) for a in (z, img, feat)]
    layers, _ = tr.deftet_sparse_render(torch.as_tensor(pix),
                                        torch.as_tensor(ranges), *leaves,
                                        **kw)
    (layers * torch.as_tensor(w)).sum().backward()
    for t, g in zip(leaves, want):
        # z only selects faces (no gradient in either package)
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)
    assert np.abs(leaves[1].grad.numpy()).sum() > 0  # xy gets gradient


def test_binning_oracles_match_jax():
    pix, ranges, z, img, _ = _random_scene(4, f=400, p=500)
    pr = np.concatenate([pix[0], ranges[0]], axis=-1)
    assert tr.hit_count_max(torch.as_tensor(pr), torch.as_tensor(z[0]),
                            torch.as_tensor(img[0]), chunk=64) == int(
        jr.hit_count_max(jnp.asarray(pr), jnp.asarray(z[0]),
                         jnp.asarray(img[0]), chunk=64))
    for chunk, n_cand in ((128, 400), (512, 1), (128, 37)):
        assert tr.bin_overflow(torch.as_tensor(img[0]),
                               torch.as_tensor(pix[0]), chunk, n_cand) == \
            jr.bin_overflow(jnp.asarray(img[0]), jnp.asarray(pix[0]),
                            chunk, n_cand)
    for sort in (True, False):
        assert tr.bin_overlap_max_np(img[0], pix[0], 96, sort=sort) == \
            jr.bin_overlap_max_np(img[0], pix[0], 96, sort=sort)
    lo, hi = pix[0, :50].min(0), pix[0, :50].max(0)
    fmin, fmax = img[0].min(1), img[0].max(1)
    for n_cand in (5, 40, 400):
        want = jr._tile_candidates(*map(jnp.asarray, (lo, hi, fmin, fmax)),
                                   n_cand)
        got = tr._tile_candidates(*map(torch.as_tensor,
                                       (lo[None], hi[None], fmin, fmax)),
                                  n_cand)
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
        assert int(got[1][0]) == int(want[1])


def test_labelled_rows_match_jax():
    """The JAX helpers' form: face rows with their own labels, -1 dead."""
    pix, ranges, z, img, _ = _random_scene(6, f=200, p=150, spread=0.3)
    label = np.random.default_rng(3).permutation(1000)[:200].astype(np.int32)
    label[::7] = -1
    args = [a[0] for a in (pix, ranges, z, img)] + [label]
    want = jr._hit_topk_ids_counted(*map(jnp.asarray, args), 64, 6)
    got = tr._hit_topk_ids_counted(*map(torch.as_tensor, args), 64, 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert (got[1].numpy() >= 0).sum() > 100


def test_peel_truncation_is_a_prefix_and_counts_are_exact():
    pix, ranges, z, img, _ = _random_scene(5, f=300, p=200, spread=0.3)
    args = [torch.as_tensor(a[0]) for a in (pix, ranges, z, img)]
    cand = torch.arange(300, dtype=torch.int32)
    offsets = torch.tensor([0, 300])
    big = tr.raster_hit(*args, cand, offsets, 200, 32, chunk=64)
    small = tr.raster_hit(*args, cand, offsets, 200, 3, chunk=64)
    assert int(big[2].max()) > 3  # truncation is real
    np.testing.assert_array_equal(small[0].numpy(), big[0][:, :3].numpy())
    np.testing.assert_array_equal(small[1].numpy(), big[1][:, :3].numpy())
    np.testing.assert_array_equal(small[2].numpy(), big[2].numpy())
    np.testing.assert_array_equal(big[2].numpy(),
                                  (big[0] >= 0).sum(1).numpy())


def test_hit_pass_tie_rule_lists_and_chunks():
    """Equal z keeps list order (lower id first with ascending lists)
    whatever the chunking; -1 entries, empty lists and a short last tile
    are handled; the result does not depend on the scan chunk."""
    z, img, _ = _tri_scene([-2.0, -1.0, -2.0, -1.0, -3.0], [[0.0]] * 5)
    pix = torch.zeros((5, 2))
    ranges = torch.tensor([[-1000.0, 0.0]]).repeat(5, 1)
    zt, it = torch.as_tensor(z[0]), torch.as_tensor(img[0])
    # tiles of 2 pixels: [all faces], [-1 slots and face 4], [empty]
    cand = torch.tensor([0, 1, 2, 3, 4, -1, 4, -1], dtype=torch.int32)
    offsets = torch.tensor([0, 5, 8, 8])
    for chunk in (1, 2, 1024):
        ids, zs, counts = tr.raster_hit(pix, ranges, zt, it, cand, offsets,
                                        2, 4, chunk=chunk)
        np.testing.assert_array_equal(ids[:2].numpy(), [[1, 3, 0, 2]] * 2)
        np.testing.assert_array_equal(ids[2:4].numpy(), [[4, -1, -1, -1]] * 2)
        np.testing.assert_array_equal(ids[4].numpy(), [-1] * 4)
        np.testing.assert_array_equal(counts.numpy(), [5, 5, 1, 1, 0])
        np.testing.assert_array_equal(zs[4].numpy(), [-1e10] * 4)
    with pytest.raises(ValueError):
        tr.raster_hit(pix, ranges, zt, it, cand, offsets[:3], 2, 4)
