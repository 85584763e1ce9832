"""The port's native (C++) topology builders against the port's numpy
builders and against the JAX package's native library, array for array.

The JAX library is built into a temporary directory of this test
(``DEFTET_NATIVE_CACHE``), so that it cannot race the build of
tests/test_native.py in another worker.  Exact equality throughout: the
builders are integer code (and a float64 rounding in
``collapse_vertices``)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deftet_tpu.native import build as jax_build
from deftet_tpu.native import topology as jax_native
from deftet_tpu_torch.native import (
    build_edge_face_pairs_native,
    build_faces_native,
    build_tet_neighbors_native,
    build_topology_native,
    build_vertex_adjacency_native,
    collapse_vertices_native,
    native_available,
)
from deftet_tpu_torch.native import build as port_build
from deftet_tpu_torch.native import topology as port_native
from deftet_tpu_torch.tetgrid import build_tet_grid
from deftet_tpu_torch.tetgrid.topology import (
    build_edge_face_pairs,
    build_faces,
    build_tet_neighbors,
    build_topology,
    build_vertex_adjacency,
)

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no g++ in environment")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built (where this worker has not
    loaded it yet) into a directory of this test's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEFTET_NATIVE_CACHE",
                  str(tmp_path_factory.mktemp("jax_native")))
        assert jax_build.load_library("topology") is not None
    return jax_native


@pytest.fixture(scope="module", params=[1, 2, 3])
def grid(request):
    return build_tet_grid(request.param)


def _equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def _pairs(a, b):
    return sorted(zip(a.tolist(), b.tolist()))


def test_faces(grid, jax_lib):
    got = build_faces_native(grid.tets, grid.n_vertices)
    _equal(got, build_faces(grid.tets, grid.n_vertices))
    _equal(got, jax_lib.build_faces_native(grid.tets, grid.n_vertices))


def test_vertex_adjacency(grid, jax_lib):
    got = build_vertex_adjacency_native(grid.tets, grid.n_vertices)
    _equal(got, build_vertex_adjacency(grid.tets, grid.n_vertices))
    _equal(got, jax_lib.build_vertex_adjacency_native(grid.tets,
                                                      grid.n_vertices))


def test_tet_neighbors(grid, jax_lib):
    _, ft, fs, _ = build_faces(grid.tets, grid.n_vertices)
    got = build_tet_neighbors_native(ft, fs, grid.n_tets)
    _equal([got], [build_tet_neighbors(ft, fs, grid.n_tets)])
    _equal([got], [jax_lib.build_tet_neighbors_native(ft, fs, grid.n_tets)])


def test_edge_face_pairs(grid, jax_lib):
    """The same set as the numpy builder (which lists the pairs by
    incidence column), in the JAX native library's order."""
    fv, _, _, _ = build_faces(grid.tets, grid.n_vertices)
    got = build_edge_face_pairs_native(fv, grid.n_vertices)
    assert _pairs(*got) == _pairs(*build_edge_face_pairs(fv,
                                                         grid.n_vertices))
    _equal(got, jax_lib.build_edge_face_pairs_native(fv, grid.n_vertices))


@pytest.mark.parametrize("with_incidence", [True, False])
def test_topology(grid, jax_lib, with_incidence):
    """Every field: equal to ``build_topology``'s (the edge pairs as a set;
    without the incidence its two arrays are (0, 1)), and to the JAX
    package's ``build_topology_native`` in order."""
    got = build_topology_native(grid.tets, grid.n_vertices,
                                with_incidence=with_incidence)
    ref = build_topology(grid.tets, grid.n_vertices)
    jref = jax_lib.build_topology_native(grid.tets, grid.n_vertices,
                                         with_incidence=with_incidence)
    assert (got.n_vertices, got.n_tets) == (ref.n_vertices, ref.n_tets)
    for f in dataclasses.fields(got):
        g, j = getattr(got, f.name), getattr(jref, f.name)
        if not isinstance(g, np.ndarray):
            assert g == j
            continue
        _equal([g], [j])
        r = getattr(ref, f.name)
        if f.name in ("edge_pair_fa", "edge_pair_fb"):
            continue
        if f.name in ("edge_face_idx", "edge_face_mask") and \
                not with_incidence:
            assert g.shape == (0, 1)
            continue
        _equal([g], [r])
    assert _pairs(got.edge_pair_fa, got.edge_pair_fb) == _pairs(
        ref.edge_pair_fa, ref.edge_pair_fb)


def _collapse_reference(verts, decimals):
    """collapse_vertices' semantics in numpy: keys rounded half away from
    zero, unique keys in lexicographic order, each group's lowest index."""
    q = verts * float(10 ** decimals)
    keys = (np.sign(q) * np.floor(np.abs(q) + 0.5)).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    rep = np.full(len(uniq), len(verts))
    np.minimum.at(rep, inverse.reshape(-1), np.arange(len(verts)))
    return verts[rep], inverse.reshape(-1).astype(np.int32)


def _cloud(seed=7):
    """A seeded cloud with planted duplicates: exact copies, copies moved
    by 1e-7 (collapse at 5 decimals) and by 1e-4 (kept apart)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (400, 3)).round(3)
    picks = rng.integers(0, len(base), 300)
    near = base[picks[:100]] + rng.choice([-1e-7, 1e-7], (100, 3))
    far = base[picks[100:200]] + 1e-4
    cloud = np.concatenate([base, base[picks[200:]], near, far])
    return cloud[rng.permutation(len(cloud))]


@pytest.mark.parametrize("case", ["four_points", "cloud"])
def test_collapse_vertices(jax_lib, case):
    if case == "four_points":
        verts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 0.0, 0.000001], [1.0, 0.0, 0.0]])
    else:
        verts = _cloud()
    uniq, remap = collapse_vertices_native(verts, decimals=5)
    j_uniq, j_remap = jax_lib.collapse_vertices_native(verts, decimals=5)
    _equal([uniq, remap], [j_uniq, j_remap])
    _equal([uniq, remap], list(_collapse_reference(verts, 5)))
    if case == "four_points":
        assert uniq.shape[0] == 2
        assert remap[0] == remap[2] and remap[1] == remap[3]
        assert remap[0] != remap[1]
    else:
        assert 400 < uniq.shape[0] < len(verts)


def test_library_lands_in_the_checkout():
    lib = port_native._lib()
    path = Path(lib._name)
    assert path.parent == ROOT / "build" / "native"
    assert path == port_build.library_path("topology") and path.exists()


def test_no_compiler_raises(monkeypatch):
    """Without g++ every wrapper raises; none falls back to numpy."""
    monkeypatch.setattr(port_build, "_CACHE", {})
    monkeypatch.setattr(port_build, "native_available", lambda: False)
    grid = build_tet_grid(1)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        build_faces_native(grid.tets, grid.n_vertices)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        build_topology_native(grid.tets, grid.n_vertices)


def test_bad_indices_raise():
    """The C code indexes through its inputs unchecked: a wrong width or an
    index out of range raises before the call."""
    grid = build_tet_grid(1)
    with pytest.raises(ValueError, match="expected"):
        build_faces_native(grid.tets[:, :3], grid.n_vertices)
    with pytest.raises(ValueError, match="outside"):
        build_vertex_adjacency_native(grid.tets, grid.n_vertices - 1)
    fv, ft, fs, _ = build_faces(grid.tets, grid.n_vertices)
    with pytest.raises(ValueError, match="outside"):
        build_tet_neighbors_native(ft, fs, grid.n_tets - 1)
    with pytest.raises(ValueError, match="outside"):
        build_edge_face_pairs_native(-fv, grid.n_vertices)
    with pytest.raises(ValueError, match="expected"):
        collapse_vertices_native(np.zeros((4, 2)))


PROBE = r"""
import json
import deftet_tpu_torch.native
from deftet_tpu_torch.native import build
print(json.dumps({"loaded": sorted(build._CACHE), "built": build.build_log}))
"""


def test_import_compiles_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"loaded": [], "built": {}}
