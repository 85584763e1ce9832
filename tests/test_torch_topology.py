"""The port's numpy topology builders against the JAX package's, array
for array and bit for bit (dtype included): the generic ``build_topology``
on a Kuhn grid and on a 1->8 split grid, the lattice's class-major
``build_lattice_topology`` (with and without its face-derived arrays), a
``.tet`` round trip, ``Topology.save`` / ``load``, the general grid's
``build_grid_statics``, and ``lattice_layout``, the one recognition of the
regular lattice that the statics carry."""

import dataclasses

import numpy as np
import pytest

import torch_parity as tp
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.tetgrid import lattice_faces as jax_lattice
from deftet_tpu.tetgrid import topology as jax_topology
from deftet_tpu.train import statics as jax_statics
from deftet_tpu.native import build as jax_build
from deftet_tpu.native import topology as jax_native
from deftet_tpu_torch.native import native_available
from deftet_tpu_torch.native import topology as port_native
from deftet_tpu_torch.nn.gcn import LatticeAdjacency
from deftet_tpu_torch.tetgrid import (
    Topology,
    build_lattice_edge_arrays,
    build_lattice_topology,
    build_tet_grid,
    build_topology,
    face_lattice_info,
    lattice_layout,
)
from deftet_tpu_torch.tetgrid.topology import FACE_ARRAYS
from deftet_tpu_torch.train import Engine, statics


def assert_same_topology(got, ref, skip=()):
    for field in dataclasses.fields(ref):
        if field.name in skip:
            continue
        g, r = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(r, int):
            assert g == r, field.name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, field.name
        np.testing.assert_array_equal(g, r, err_msg=field.name)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return tp.split_grid(tmp_path_factory.mktemp("grid") / "split.tet")


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library, loaded in this process from a
    directory of this test's own before any reference call: its build
    shares one temporary file name across processes, and a reference
    whose build fails falls back to numpy (another pair order)."""
    if native_available():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DEFTET_NATIVE_CACHE",
                      str(tmp_path_factory.mktemp("jax_native")))
            assert jax_build.load_library("topology") is not None


@pytest.mark.parametrize("kind", ["kuhn3", "split2"])
def test_build_topology_matches_reference(kind, split):
    if kind == "kuhn3":
        tets, n = build_tet_grid(3).tets, build_tet_grid(3).n_vertices
        assert np.array_equal(tets, jax_grid(3).tets)
    else:
        tets, n = split[1].tets, split[1].n_vertices
        assert face_lattice_info(split[1]) is None  # not a lattice
    assert_same_topology(build_topology(tets, n),
                         jax_topology.build_topology(tets, n))


@pytest.mark.parametrize("res", [2, 3])
def test_lattice_topology_matches_reference(res):
    grid = build_tet_grid(res)
    ref = jax_lattice.build_lattice_topology(jax_grid(res))
    got = build_lattice_topology(grid)
    if native_available():
        # both packages take their native builders: every field in order
        assert_same_topology(got, ref)
    else:
        # both take numpy, whose pairs the native builders list in another
        # order: held as a set, as a machine without g++ can
        assert_same_topology(got, ref, skip=("edge_pair_fa", "edge_pair_fb"))
    assert sorted(zip(got.edge_pair_fa, got.edge_pair_fb)) == sorted(
        zip(ref.edge_pair_fa, ref.edge_pair_fb))
    for got_a, ref_a in zip(build_lattice_edge_arrays(res),
                            jax_lattice.build_lattice_edge_arrays(res)):
        np.testing.assert_array_equal(got_a, ref_a)
    bare = build_lattice_topology(grid, face_arrays=False)
    assert all(getattr(bare, f) is None for f in FACE_ARRAYS)
    assert_same_topology(bare, ref, skip=FACE_ARRAYS)


def test_tet_file_round_trip_and_topology_save_load(split, tmp_path):
    jgrid, grid = split
    for name in ("vertices", "tets", "interior_mask"):
        a, b = getattr(grid, name), getattr(jgrid, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert grid.resolution == jgrid.resolution == 0
    g = build_tet_grid(2)
    assert grid.n_vertices == 5**3 and grid.n_tets == 8 * g.n_tets
    topo = build_topology(grid.tets, grid.n_vertices)
    topo.save(str(tmp_path / "topo.npz"))
    assert_same_topology(Topology.load(str(tmp_path / "topo.npz")), topo)
    # a lattice topology without its face arrays saves what it has
    bare = build_lattice_topology(g, face_arrays=False)
    bare.save(str(tmp_path / "bare.npz"))
    back = Topology.load(str(tmp_path / "bare.npz"))
    assert all(getattr(back, f) is None for f in FACE_ARRAYS)
    assert_same_topology(back, bare, skip=FACE_ARRAYS)


def test_general_grid_statics_match_reference(split):
    jgrid, grid = split
    ref = jax_statics.build_grid_statics(4, grid=jgrid)
    got = statics.build_grid_statics(4, grid=grid)
    for name in ref._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        if name == "rest_inverse_tx3x3":
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    # a grid read from a file has no resolution: no lattice fast path
    assert statics.lattice_offsets(grid) is None
    assert statics.lattice_tet_offsets(grid) is None
    # the lattice at a compaction budget leaves the face tables out
    bare = statics.build_grid_statics(3, face_arrays=False)
    assert bare.edge_face_idx is None and bare.vert_face_inc_idx is None
    assert bare.vert_adj_idx is not None and bare.vert_tet_inc_idx is not None


def test_general_grid_statics_take_the_reference_topology(split,
                                                          monkeypatch):
    """On a non-lattice grid ``build_grid_statics`` takes
    ``build_topology_native`` exactly where the reference does (g++ on
    the path), and the topology it takes equals the reference's in
    order, the edge-face pairs included."""
    jgrid, grid = split
    taken = []
    native_builder = port_native.build_topology_native

    def spy(tets, n):
        taken.append(native_builder(tets, n))
        return taken[-1]

    monkeypatch.setattr(port_native, "build_topology_native", spy)
    statics.build_grid_statics(4, grid=grid)
    assert len(taken) == int(native_available())
    if taken:
        assert_same_topology(taken[0], jax_native.build_topology_native(
            jgrid.tets, jgrid.n_vertices))


@pytest.mark.parametrize("case", ["split", "lattice", "engine"])
def test_lattice_layout_is_decided_once(case, split, monkeypatch):
    """A split grid has no layout, even read as res 4 (its 384 tets and
    125 vertices are the res-4 lattice's counts; the probe-derived
    ``lattice_offsets`` alone would pass it); the res-4 lattice's layout
    is ``lattice_offsets``, ``lattice_tet_offsets`` and
    ``face_lattice_info`` (the first two the JAX package's), carried by
    its statics unless a given topology is not class-major; and an engine
    given the lattice's statics decodes through the stencil."""
    lattice = build_tet_grid(4)
    layout = lattice_layout(lattice)
    if case == "split":
        grid = split[1]
        posing = dataclasses.replace(grid, resolution=4)
        assert (grid.n_tets, grid.n_vertices) == (lattice.n_tets,
                                                  lattice.n_vertices) \
            == (384, 125)
        assert statics.lattice_offsets(posing) == layout.offsets
        assert lattice_layout(grid) is None and lattice_layout(posing) is None
        assert face_lattice_info(posing) is None
        assert build_lattice_topology(posing) is None
        assert statics.build_grid_statics(4, grid=posing).lattice is None
    elif case == "lattice":
        assert layout == (4, statics.lattice_offsets(lattice),
                          statics.lattice_tet_offsets(lattice),
                          face_lattice_info(lattice))
        assert layout.offsets == jax_statics.lattice_offsets(jax_grid(4))
        assert layout.tet_offsets == jax_statics.lattice_tet_offsets(
            jax_grid(4))
        assert statics.build_grid_statics(4).lattice == layout
        assert statics.build_grid_statics(
            4, face_arrays=False).lattice == layout
        generic = build_topology(lattice.tets, lattice.n_vertices)
        assert statics.build_grid_statics(
            4, grid=lattice, topology=generic).lattice is None
    else:
        _, cfg = tp.configs()
        engine = Engine(cfg, device="cpu",
                        statics=statics.build_grid_statics(4))
        assert engine.statics.lattice == layout
        seen = []
        decode = engine.model.decode_pos

        def spy(*args, **kwargs):
            seen.append(args[4:6])  # (adjacency, lattice_res)
            return decode(*args, **kwargs)

        monkeypatch.setattr(engine.model, "decode_pos", spy)
        engine.forward_losses(engine._prep_batch(tp.batch(cfg)))
        (adj, lat_res), = seen
        assert isinstance(adj, LatticeAdjacency) and lat_res == 4
        assert adj.offsets == layout.offsets
