"""The general grid's gather paths, one function at a time, against the
JAX package on a 1->8 split grid (not a lattice), forward and backward at
float32 rtol 1e-5: the padded-gather neighbour mean (``VertexAdjacency``)
and Laplacian, ``incidence_gather`` and ``edge_face_sum`` against the
reference's custom VJPs, the incidence-gathered tet corners, the AoS AMIPS
and edge terms, the boundary faces from occupancy, the three normal terms
(uncompacted, compacted over ``edge_face_sum``, the pair oracle) and
``surface_align_losses`` at budget 0 with the reference's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu.losses import geometry as jax_geometry
from deftet_tpu.losses import surface as jax_surface
from deftet_tpu.ops import geometry as jax_ops
from deftet_tpu.train import statics as jax_statics
from deftet_tpu_torch.losses import geometry, surface
from deftet_tpu_torch.nn.gcn import VertexAdjacency
from deftet_tpu_torch.ops import geometry as ops
from deftet_tpu_torch.train import statics

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(JAX statics, port statics, rng-perturbed positions (B, N, 3))."""
    jgrid, pgrid = tp.split_grid(tmp_path_factory.mktemp("g") / "s.tet")
    jstat = jax_statics.build_grid_statics(4, grid=jgrid)
    pstat = statics.build_grid_statics(4, grid=pgrid)
    rng = np.random.default_rng(0)
    pos = (np.asarray(jstat.init_pos_nx3)[None]
           + rng.normal(0, 0.02, (2, pgrid.n_vertices, 3))).astype(np.float32)
    return jstat, pstat, pos


def _vjp(fn, *args, cot_seed=1):
    """(output, cotangent, input cotangents) of the JAX function."""
    out, vjp = jax.vjp(fn, *args)
    rng = np.random.default_rng(cot_seed)
    cot = jax.tree_util.tree_map(
        lambda o: jnp.asarray(rng.normal(size=o.shape), o.dtype), out)
    return out, cot, vjp(cot)


def _torch_grads(out, cot, *inputs):
    outs = out if isinstance(out, (list, tuple)) else [out]
    cots = cot if isinstance(cot, (list, tuple)) else [cot]
    return torch.autograd.grad(
        outs, inputs, [torch.tensor(np.asarray(c)).to(o.dtype)
                       for o, c in zip(outs, cots)], retain_graph=True)


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(ref, np.float32), rtol=rtol, atol=atol,
        err_msg=msg)


def test_vertex_adjacency_and_laplacian_match_reference(grid):
    jstat, pstat, pos = grid
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, pos.shape[1], 5)).astype(np.float32)
    args = (jstat.vert_adj_idx, jstat.vert_adj_mask, jstat.vert_degree)
    ref, cot, (g_ref,) = _vjp(
        lambda v: jax_geometry.neighbor_mean(v, *args), jnp.asarray(x))
    adj = VertexAdjacency(pstat.vert_adj_idx, pstat.vert_adj_mask,
                          pstat.vert_degree)
    xt = torch.tensor(x, requires_grad=True)
    out = adj.matmul(xt)
    assert out.dtype == torch.float32
    _close(out, ref)
    _close(_torch_grads(out, cot, xt)[0], g_ref)

    ref, cot, (g_ref,) = _vjp(
        lambda v: jax_geometry.laplacian_loss(v, *args), jnp.asarray(pos))
    pt = torch.tensor(pos, requires_grad=True)
    out = geometry.laplacian_loss(pt, pstat.vert_adj_idx, pstat.vert_adj_mask,
                                  pstat.vert_degree)
    _close(out, ref)
    _close(_torch_grads(out, cot, pt)[0], g_ref)
    # bf16 input: float32 output, the gradient back in bf16
    xb = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    out = adj.matmul(xb)
    ref = jax_geometry.neighbor_mean(jnp.asarray(x, jnp.bfloat16), *args)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref)
    assert torch.autograd.grad(out.sum(), xb)[0].dtype == torch.bfloat16


def test_incidence_gather_and_tet_corners_match_reference(grid):
    jstat, pstat, pos = grid
    flat_j = jnp.swapaxes(jstat.tet_tx4, 0, 1).reshape(-1)
    ref, cot, (g_ref, *_) = _vjp(
        lambda v: jax_ops.incidence_gather(v, flat_j, jstat.vert_tet_inc_idx,
                                           jstat.vert_tet_inc_mask),
        jnp.asarray(pos[..., 0]))
    xt = torch.tensor(pos[..., 0], requires_grad=True)
    out = ops.incidence_gather(xt, pstat.tet_tx4.t().reshape(-1),
                               pstat.vert_tet_inc_idx,
                               pstat.vert_tet_inc_mask)
    _close(out, ref, 0, 0)
    (g,) = _torch_grads(out, cot, xt)
    _close(g, g_ref)
    # deterministic: a second backward gives the same bits
    (g2,) = _torch_grads(out, cot, xt)
    assert torch.equal(g, g2)

    inc = (jstat.vert_tet_inc_idx, jstat.vert_tet_inc_mask)
    ref, cot, (g_ref,) = _vjp(
        lambda p: jax_geometry.gather_tet_soa(p, jstat.tet_tx4,
                                              vert_tet_inc=inc),
        jnp.asarray(pos))
    pt = torch.tensor(pos, requires_grad=True)
    soa = geometry.gather_tet_soa(
        pt, pstat.tet_tx4,
        vert_tet_inc=(pstat.vert_tet_inc_idx, pstat.vert_tet_inc_mask))
    for k in range(4):
        for c in range(3):
            _close(soa[k][c], ref[k][c], 0, 0)
    flat = [soa[k][c] for k in range(4) for c in range(3)]
    flat_cot = [cot[k][c] for k in range(4) for c in range(3)]
    _close(_torch_grads(flat, flat_cot, pt)[0], g_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_face_sum_matches_reference(grid, dtype):
    jstat, pstat, _ = grid
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, pstat.face_fx3.shape[0])).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref, cot, (g_ref, *_) = _vjp(
        lambda v: jax_ops.edge_face_sum(v, jstat.edge_face_idx,
                                        jstat.edge_face_mask,
                                        jstat.face_edge_ids), jx)
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    out = ops.edge_face_sum(xt, pstat.edge_face_idx, pstat.edge_face_mask,
                            pstat.face_edge_ids)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref)
    (g,) = _torch_grads(out, cot, xt)
    assert g.dtype == xt.dtype
    _close(g, g_ref)
    assert torch.equal(g, _torch_grads(out, cot, xt)[0])


def test_aos_amips_and_edge_length_match_reference(grid):
    jstat, pstat, pos = grid
    tets = pos[:, np.asarray(jstat.tet_tx4)]
    for name, args in (("amips_energy", (jstat.rest_inverse_tx3x3,)),
                       ("edge_length", ())):
        ref, cot, (g_ref, *_) = _vjp(
            lambda t, fn=getattr(jax_geometry, name): fn(t, *args),
            jnp.asarray(tets))
        tt = torch.tensor(tets, requires_grad=True)
        targs = [pstat.rest_inverse_tx3x3] if args else []
        out = getattr(geometry, name)(tt, *targs)
        _close(out, ref, msg=name)
        _close(_torch_grads(out, cot, tt)[0], g_ref, 1e-4, 1e-5, msg=name)


def _occupancy(pstat, seed=4):
    """Per-tet occupancy {0, 1}: tets whose centre lies in a ball."""
    centers = pstat.init_pos_nx3[pstat.tet_tx4].mean(dim=1).numpy()
    rng = np.random.default_rng(seed)
    occ = np.stack([np.linalg.norm(centers - rng.uniform(-0.1, 0.1, 3),
                                   axis=-1) < r for r in (0.3, 0.25)])
    return occ.astype(np.float32)


def test_boundary_from_occupancy_matches_reference(grid):
    jstat, pstat, _ = grid
    occ = _occupancy(pstat)
    ref_mask, ref_sign = jax_surface.boundary_info_from_occupancy(
        jnp.asarray(occ), jstat.face_tet_fx2)
    mask, sign = surface.boundary_info_from_occupancy(
        torch.tensor(occ), pstat.face_tet_fx2)
    _close(mask, ref_mask, 0, 0)
    _close(sign, ref_sign, 0, 0)
    assert float(mask.sum()) > 0
    ref_faces, ref_m = jax_surface.boundary_faces_from_occupancy(
        jnp.asarray(occ), jstat.face_fx3, jstat.face_tet_fx2)
    faces, m = surface.boundary_faces_from_occupancy(
        torch.tensor(occ), pstat.face_fx3, pstat.face_tet_fx2)
    np.testing.assert_array_equal(faces.numpy(), np.asarray(ref_faces))
    _close(m, ref_m, 0, 0)


def _edge_topo(st):
    return (st.edge_face_idx, st.edge_face_mask, st.face_edge_ids,
            st.vert_face_inc_idx, st.vert_face_inc_mask)


def test_normal_terms_match_reference(grid):
    jstat, pstat, pos = grid
    occ = _occupancy(pstat)
    jmask, jsign = jax_surface.boundary_info_from_occupancy(
        jnp.asarray(occ), jstat.face_tet_fx2)
    mask, sign = (torch.tensor(np.asarray(a)) for a in (jmask, jsign))

    ref, cot, (g_ref,) = _vjp(
        lambda p: jax_surface.normal_smoothness_loss(
            p, jstat.face_fx3, jmask, jsign, _edge_topo(jstat)),
        jnp.asarray(pos))
    pt = torch.tensor(pos, requires_grad=True)
    out = surface.normal_smoothness_loss(pt, pstat.face_fx3, mask, sign,
                                         _edge_topo(pstat))
    _close(out, ref)
    _close(_torch_grads(out, cot, pt)[0], g_ref)
    assert float(out.detach().min()) > 0

    # the explicit-pair oracle gives the per-edge closed form's value
    faces, _ = surface.boundary_faces_from_occupancy(
        torch.tensor(occ), pstat.face_fx3, pstat.face_tet_fx2)
    topo = tp.build_topology_of(pstat)
    pairs = surface.normal_smoothness_loss_pairs(
        pt, faces, mask, torch.tensor(topo.edge_pair_fa),
        torch.tensor(topo.edge_pair_fb))
    ref_pairs = jax_surface.normal_smoothness_loss_pairs(
        jnp.asarray(pos), jnp.asarray(faces.numpy()), jmask,
        jnp.asarray(topo.edge_pair_fa), jnp.asarray(topo.edge_pair_fb))
    _close(pairs, ref_pairs)
    _close(pairs, ref, 1e-4, 1e-6)

    # compacted, on a general grid: bf16 fields over edge_face_sum
    k = 30
    work_faces, work_mask, work_idx = \
        jax_surface.select_boundary_subset_static(jstat.face_fx3, jmask, k,
                                                  return_idx=True)
    assert float(jnp.sum(jmask, axis=1).min()) > k  # an overflowing budget

    def compacted(p):
        work_pos = p[jnp.arange(2)[:, None, None], work_faces]
        return jax_surface.normal_smoothness_loss_compacted(
            work_pos, work_idx, work_mask, jmask, jsign, _edge_topo(jstat))

    ref, cot, (g_ref,) = _vjp(compacted, jnp.asarray(pos))
    idx = torch.tensor(np.asarray(work_idx)).long()
    work_pos = pt[torch.arange(2)[:, None, None], pstat.face_fx3[idx]]
    out = surface.normal_smoothness_loss_compacted(
        work_pos, idx, torch.tensor(np.asarray(work_mask)), mask, sign,
        edge_topo=_edge_topo(pstat))
    _close(out, ref, 1e-4, 1e-6)
    _close(_torch_grads(out, cot, pt)[0], g_ref, 1e-3, 1e-5)


def test_surface_align_losses_uncompacted_match_reference(grid):
    jstat, pstat, pos = grid
    occ = _occupancy(pstat)
    jmask, jsign = jax_surface.boundary_info_from_occupancy(
        jnp.asarray(occ), jstat.face_tet_fx2)
    mask, sign = (torch.tensor(np.asarray(a)) for a in (jmask, jsign))
    rng = np.random.default_rng(5)
    gt = rng.uniform(-0.3, 0.3, (2, 200, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    n_faces, per_face = pstat.face_fx3.shape[0], 3

    def ref_fn(p):
        return jax_surface.surface_align_losses(
            key, p, jstat.face_fx3, jmask, jsign, jnp.asarray(gt),
            _edge_topo(jstat), per_face_samples=per_face,
            max_boundary_faces=0, samples_cap=200_000)

    ref, cot, (g_ref,) = _vjp(ref_fn, jnp.asarray(pos))
    ku, kv = jax.random.split(key)
    shape = (2, n_faces, per_face, 1)
    bary = tuple(torch.tensor(np.asarray(jax.random.uniform(k, shape)))
                 for k in (ku, kv))
    pt = torch.tensor(pos, requires_grad=True)
    out = surface.surface_align_losses(
        pt, pstat.face_fx3, mask, sign, torch.tensor(gt),
        per_face_samples=per_face, max_boundary_faces=0,
        samples_cap=200_000, bary=bary, edge_topo=_edge_topo(pstat))
    for name, o, r in zip(("chamfer", "analytic", "normal"), out, ref):
        _close(o, r, msg=name)
        assert float(o.detach().min()) > 0, name
    _close(_torch_grads(list(out), list(cot), pt)[0], g_ref, 1e-4, 1e-6)
