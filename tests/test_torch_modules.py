"""The port's networks on converted flax parameters against the JAX
package: the PVCNN encoder (train mode with its updated running
statistics, and eval mode), the GCN decoder and the three methods of
DeformableTetNetwork; plus the numpy data and voxel-read copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu.data.pipeline import occupancy_grid as jax_occupancy_grid
from deftet_tpu.data.shapes import random_shape as jax_random_shape
from deftet_tpu.nn import GCNMLPDecoder as JaxGCN
from deftet_tpu.nn import LatticeAdjacency as JaxLattice
from deftet_tpu.ops.voxelize import occupancy_from_grid_soa as jax_occ_soa
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.train import statics as jax_statics
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.data.pipeline import occupancy_grid
from deftet_tpu_torch.data.shapes import random_shape
from deftet_tpu_torch.nn import GCNMLPDecoder, LatticeAdjacency
from deftet_tpu_torch.ops.voxelize import occupancy_from_grid_soa

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def nets():
    jcfg, cfg = tp.configs()
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    model = tp.jax_model(jcfg, jstat)
    variables = tp.jax_variables(model, jcfg, jstat, seed=4)
    offsets = jax_statics.lattice_offsets(grid)
    return jcfg, cfg, jstat, model, variables, offsets


def _points(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.45, 0.45, (cfg.batch_size, cfg.n_point, 3)).astype(
        np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_pvcnn_encoder(nets, train):
    _, cfg, _, model, variables, _ = nets
    pts = _points(cfg, 1)
    port = tp.port_model(cfg, variables)

    def enc(m, x):
        return m.encoder_pos(x, train=train)

    if train:
        ref, mutated = model.apply(variables, jnp.asarray(pts), method=enc,
                                   mutable=["batch_stats"])
    else:
        ref = model.apply(variables, jnp.asarray(pts), method=enc)
    got = port.encoder_pos(torch.tensor(pts), train)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        _close(g, r)
    if train:
        stats = tp.flax_layout(port, dict(port.named_buffers()))
        tp.assert_tree_close(
            {"encoder_pos": tp.numpy_tree(
                mutated["batch_stats"]["encoder_pos"])},
            stats, RTOL, 1e-6, "running stats")


def test_gcn_decoder_on_lattice(nets):
    jcfg, _, jstat, _, _, offsets = nets
    n = jcfg.res + 1
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, n**3, 12)).astype(np.float32)
    jdec = JaxGCN(gcn_hidden=(16, 16, 8), mlp_hidden=(8,), out_dim=3)
    jadj = JaxLattice(offsets=offsets, degree=jstat.vert_degree)
    variables = jdec.init(jax.random.PRNGKey(5), jnp.asarray(feat), jadj,
                          train=False)
    ref, _ = jdec.apply(variables, jnp.asarray(feat), jadj, train=True,
                        mutable=["batch_stats"])

    dec = GCNMLPDecoder(12, (16, 16, 8), (8,), 3)
    load_flax_variables(dec, tp.numpy_tree(variables))
    adj = LatticeAdjacency.from_degree(
        offsets, torch.tensor(np.asarray(jstat.vert_degree)))
    got = dec(torch.tensor(feat), adj, train=True)
    _close(got, ref)


def test_network_methods(nets):
    jcfg, cfg, jstat, model, variables, offsets = nets
    pts = _points(cfg, 3)
    b = cfg.batch_size
    init = np.broadcast_to(np.asarray(jstat.init_pos_nx3)[None],
                           (b,) + jstat.init_pos_nx3.shape)
    mask = np.broadcast_to(np.asarray(jstat.pos_mask_nx3)[None], init.shape)
    centers = _points(cfg, 4)[:, :50]
    jadj = JaxLattice(offsets=offsets, degree=jstat.vert_degree)

    def run(m, x, p, pm, c):
        pyr_pos, pyr_occ = m.encode(x, train=False)
        delta, pos, ori = m.decode_pos(p, pyr_pos, pm, train=False, adj=jadj,
                                       lattice_res=jcfg.res)
        return pyr_pos, pyr_occ, delta, pos, ori, m.decode_occ(
            c, pyr_occ, train=False)

    ref = model.apply(variables, *map(jnp.asarray, (pts, init, mask, centers)),
                      method=run)

    port = tp.port_model(cfg, variables).eval()
    adj = LatticeAdjacency.from_degree(
        offsets, torch.tensor(np.asarray(jstat.vert_degree)))
    pyr_pos, pyr_occ = port.encode(torch.tensor(pts), train=False)
    delta, pos, ori = port.decode_pos(
        torch.tensor(init), pyr_pos, torch.tensor(mask), train=False, adj=adj,
        lattice_res=jcfg.res)
    logits = port.decode_occ(torch.tensor(centers), pyr_occ, train=False)
    for g, r in zip(list(pyr_pos) + list(pyr_occ), list(ref[0]) + list(ref[1])):
        _close(g, r)
    for g, r in zip((delta, pos, ori, logits), ref[2:]):
        assert g.shape == r.shape
        _close(g, r)
    # the separable lattice probe equals the per-point probe
    per_point = port.decode_pos(torch.tensor(init), pyr_pos, torch.tensor(mask),
                                train=False, adj=adj)
    _close(per_point[0], ref[2])


def test_data_copies_match_reference():
    for seed in (0, 1, 2):
        v, f = random_shape(seed, level=1)
        jv, jf = jax_random_shape(seed, level=1)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    v, f = random_shape(0, level=2)
    np.testing.assert_array_equal(occupancy_grid(v, f, 20),
                                  jax_occupancy_grid(v, f, 20))


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_occupancy_read_matches_reference(interp):
    v, f = random_shape(1, level=1)
    grid = np.stack([occupancy_grid(v, f, 16)] * 2)
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-0.6, 0.6, (3, 2, 500)).astype(np.float32)
    ref = jax_occ_soa(jnp.asarray(grid), *map(jnp.asarray, xyz),
                      interp=interp)
    got = occupancy_from_grid_soa(torch.tensor(grid),
                                  *map(torch.tensor, xyz), interp=interp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
