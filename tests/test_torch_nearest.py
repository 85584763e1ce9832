"""K2 nearest neighbour: the port's plain version against the Pallas
kernel (interpret mode) — n_valid masking, the n_queries tile skip and
reference clouds past the Pallas VMEM cap.  (The plain version is held
against the Pallas kernel, not the CPU XLA path, which uses the
|a|^2+|b|^2-2ab expansion.)  The CUDA kernel is held against the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import torch

from deftet_tpu.ops import nearest_pallas
from deftet_tpu_torch.ops import nearest


def _clouds(seed, b, p, m):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    return q, r


def _compare(q, r, nv, nq, **pallas_kw):
    d_ref, i_ref = nearest_pallas.nearest_neighbor_pallas(
        jnp.asarray(q), jnp.asarray(r),
        None if nv is None else jnp.asarray(nv),
        None if nq is None else jnp.asarray(nq),
        interpret=True, **pallas_kw)
    d, i = nearest.nearest_neighbor(
        torch.tensor(q), torch.tensor(r),
        None if nv is None else torch.tensor(nv),
        None if nq is None else torch.tensor(nq))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref),
                               rtol=1e-5, atol=1e-6)
    return d.numpy(), i.numpy()


def test_plain_nn_matches_pallas_with_n_valid():
    q, r = _clouds(5, 2, 700, 300)
    nv = np.array([300, 180], np.int32)
    _, i = _compare(q, r, nv, None, m_chunk=128)
    assert (i[1] < 180).all()


def test_plain_nn_query_tile_skip():
    q, r = _clouds(9, 2, 1300, 200)
    nq = np.array([300, 1030], np.int32)
    d, i = _compare(q, r, None, nq, m_chunk=64)
    # 512-query tiles wholly past n_queries return (0, 0)
    assert (d[0, 512:] == 0).all() and (i[0, 512:] == 0).all()
    assert (d[1, 1536:] == 0).all()
    assert (d[1, :1030] > 0).all()


def test_plain_nn_refs_beyond_vmem_cap(monkeypatch):
    # the Pallas wrapper scans reference chunks past its residency cap;
    # a reduced cap exercises that path at test size
    monkeypatch.setattr(nearest_pallas, "_M_RESIDENT_CAP", 512)
    q, r = _clouds(11, 2, 600, 1300)
    nv = np.array([1300, 600], np.int32)
    _compare(q, r, nv, None, m_chunk=128)


def test_plain_nn_no_valid_reference():
    q, r = _clouds(3, 1, 40, 30)
    nv = np.array([0], np.int32)
    d, i = _compare(q, r, nv, None, m_chunk=128)
    assert (i == 0).all() and (d >= 1e29).all()


def test_sided_distance_gradient_is_gather():
    q, r = _clouds(4, 1, 50, 20)
    qt = torch.tensor(q, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    d2, idx = nearest.sided_squared_distance(qt, rt)
    d2.sum().backward()
    closest = r[0, idx[0].numpy()]
    np.testing.assert_allclose(qt.grad.numpy()[0], 2 * (q[0] - closest),
                               rtol=1e-5, atol=1e-6)



def _duplicate_refs(seed, b, p, m, dup_idx):
    """Queries in the unit cube; references far away except, per batch, a
    copy of one point at every index of dup_idx[b], which is then the
    nearest reference of every query, tied."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (b, p, 3)).astype(np.float32)
    r = rng.uniform(10, 11, (b, m, 3)).astype(np.float32)
    for bi, idx in enumerate(dup_idx):
        r[bi, idx] = rng.uniform(0, 1, 3).astype(np.float32)
    return q, r


def test_plain_nn_duplicates_across_m_chunks():
    # copies straddling the 64-reference chunks: the lowest index wins,
    # whether it closes a chunk (63) or opens one (64)
    q, r = _duplicate_refs(21, 2, 300, 300, [[63, 64, 128, 250],
                                             [191, 64, 127, 128]])
    _, i = _compare(q, r, None, None, m_chunk=64)
    assert (i[0] == 63).all() and (i[1] == 64).all()


def test_plain_nn_duplicates_across_resident_cap_scan(monkeypatch):
    # copies on both sides of the reference-chunk scan past the residency
    # cap (reduced to 256): the earlier scan chunk keeps its index
    monkeypatch.setattr(nearest_pallas, "_M_RESIDENT_CAP", 256)
    q, r = _duplicate_refs(22, 2, 200, 700, [[255, 256, 511, 600],
                                             [513, 256, 512]])
    nv = np.array([700, 600], np.int32)
    _, i = _compare(q, r, nv, None, m_chunk=128)
    assert (i[0] == 255).all() and (i[1] == 256).all()


def test_plain_nn_duplicates_past_n_valid(monkeypatch):
    # the lowest copy lies past n_valid: the next valid copy wins, across
    # the scan past the residency cap
    monkeypatch.setattr(nearest_pallas, "_M_RESIDENT_CAP", 256)
    q, r = _duplicate_refs(23, 1, 100, 600, [[90, 300, 301]])
    nv = np.array([80], np.int32)
    _, i = _compare(q, r, nv, None, m_chunk=64)
    assert (i < 80).all()
    nv = np.array([301], np.int32)
    _, i = _compare(q, r, nv, None, m_chunk=64)
    assert (i == 90).all()


def test_plain_nn_ragged_n_queries():
    # n_queries ragged against the 512-query tile: a tile counts as live
    # when it starts before n_queries, so 2049 keeps the tile at 2048
    q, r = _clouds(24, 2, 2600, 150)
    nq = np.array([2049, 513], np.int32)
    d, i = _compare(q, r, None, nq, m_chunk=64)
    assert (d[0, 2560:] == 0).all() and (i[0, 2560:] == 0).all()
    assert (d[0, :2560] > 0).all()
    assert (d[1, 1024:] == 0).all() and (i[1, 1024:] == 0).all()
    assert (d[1, :1024] > 0).all()
