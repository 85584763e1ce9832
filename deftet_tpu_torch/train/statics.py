"""Per-grid static tensors of the train step (torch port of
deftet_tpu/train/statics.py): the regular lattice's class-major topology,
or any tet grid's through the generic builders, native (g++) where a
compiler is on the path and numpy otherwise, as in the JAX package.
``adjacency_for``, ``tet_soa_for`` and ``face_lattice_for`` read the
statics' lattice layout: the one dispatch of the step and the evaluation
between the lattice's fast paths and the gather paths."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..losses.geometry import gather_tet_soa, gather_tet_soa_lattice
from ..nn.gcn import LatticeAdjacency, VertexAdjacency
from ..ops.geometry import tet_rest_inverse
from ..tetgrid import (
    LatticeLayout,
    TetGrid,
    Topology,
    build_lattice_topology,
    build_tet_grid,
    build_topology,
    lattice_layout,
)
# defined here in the JAX package; the port keeps them beside the layout
from ..tetgrid.lattice_faces import lattice_offsets, lattice_tet_offsets


class GridStatics(NamedTuple):
    """Index tensors are int64.  The face-derived gather tables
    (``edge_face_*``, ``face_edge_ids``, ``vert_face_inc_*``) are None
    where they were not built (the lattice at a compaction budget)."""

    init_pos_nx3: torch.Tensor        # (N, 3) float32 in [-0.5, 0.5]
    pos_mask_nx3: torch.Tensor        # (N, 3) float32 deformable mask
    tet_tx4: torch.Tensor             # (T, 4)
    face_fx3: torch.Tensor            # (F, 3) interior faces
    face_tet_fx2: torch.Tensor        # (F, 2) owning tets
    edge_face_idx: torch.Tensor       # (E, M) faces incident per edge
    edge_face_mask: torch.Tensor      # (E, M) float32
    face_edge_ids: torch.Tensor       # (F, 3)
    vert_face_inc_idx: torch.Tensor   # (N, M) face-corner slots
    vert_face_inc_mask: torch.Tensor  # (N, M) float32
    vert_tet_inc_idx: torch.Tensor    # (N, Mt) tet-corner slots
    vert_tet_inc_mask: torch.Tensor   # (N, Mt) float32
    vert_adj_idx: torch.Tensor        # (N, Ma) neighbour vertices
    vert_adj_mask: torch.Tensor       # (N, Ma) float32
    vert_degree: torch.Tensor         # (N,) int32
    rest_inverse_tx3x3: torch.Tensor  # (T, 3, 3) float32
    lattice: LatticeLayout | None = None  # None: the gather paths

    @property
    def n_vertices(self) -> int:
        return self.init_pos_nx3.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tet_tx4.shape[0]


def build_grid_statics(resolution: int, grid: TetGrid | None = None,
                       topology: Topology | None = None, device="cpu",
                       face_arrays: bool = True) -> GridStatics:
    """Build (or adopt) a grid and its topology and lift them to
    ``device``: the class-major lattice topology for the regular Kuhn
    grid, else ``build_topology``, as in the JAX package through the
    native builders wherever g++ is on the path (``build_topology_native``;
    its edge-face pairs listed edge by edge) and raising where g++ is
    present but the library fails to build or load.  ``face_arrays=False``
    skips the lattice's face-derived gather tables (read only by the
    uncompacted normal term).  ``lattice`` is the grid's layout where the
    faces are class-major (a given ``topology``'s are checked)."""
    if grid is None:
        grid = build_tet_grid(resolution)
    layout = lattice_layout(grid)
    if topology is None:
        topology = build_lattice_topology(grid, face_arrays=face_arrays)
    if topology is None:
        from ..native import build as native_build
        from ..native import topology as native

        topology = (native.build_topology_native
                    if native_build.native_available()
                    else build_topology)(grid.tets, grid.n_vertices)
    if layout is not None and topology.face_fx3.shape[0] != 12 * layout.res**3:
        layout = None
    dev = torch.device(device)

    def lift(name, dtype=None):
        a = getattr(topology, name)
        if a is None:
            return None
        t = torch.as_tensor(a)
        return t.to(device=dev, dtype=torch.int64 if dtype is None and
                    not t.is_floating_point() else dtype)

    init_pos = torch.as_tensor(
        grid.centered_vertices().astype(np.float32), device=dev)
    tet_tx4 = lift("tet_tx4")
    return GridStatics(
        init_pos_nx3=init_pos,
        pos_mask_nx3=torch.as_tensor(
            grid.interior_mask.astype(np.float32), device=dev),
        tet_tx4=tet_tx4,
        face_fx3=lift("face_fx3"),
        face_tet_fx2=lift("face_tet_fx2"),
        edge_face_idx=lift("edge_face_idx"),
        edge_face_mask=lift("edge_face_mask"),
        face_edge_ids=lift("face_edge_ids"),
        vert_face_inc_idx=lift("vert_face_inc_idx"),
        vert_face_inc_mask=lift("vert_face_inc_mask"),
        vert_tet_inc_idx=lift("vert_tet_inc_idx"),
        vert_tet_inc_mask=lift("vert_tet_inc_mask"),
        vert_adj_idx=lift("vert_adj_idx"),
        vert_adj_mask=lift("vert_adj_mask"),
        vert_degree=lift("vert_degree", torch.int32),
        rest_inverse_tx3x3=tet_rest_inverse(init_pos, tet_tx4),
        lattice=layout,
    )


def statics_to(statics: GridStatics, device) -> GridStatics:
    """``statics`` with every tensor on ``device`` (the layout as it is)."""
    return GridStatics(*(t.to(device) if isinstance(t, torch.Tensor) else t
                         for t in statics))


def adjacency_for(statics: GridStatics):
    """(adjacency, lattice_res): the stencil and the separable probe on
    the lattice, else the padded gather and the per-vertex probe."""
    lat = statics.lattice
    if lat is not None:
        return LatticeAdjacency.from_degree(lat.offsets,
                                            statics.vert_degree), lat.res
    return VertexAdjacency(idx=statics.vert_adj_idx,
                           mask=statics.vert_adj_mask,
                           degree=statics.vert_degree), 0


def tet_soa_for(tet_pos, statics: GridStatics):
    """Every tet's corners in SoA form: lattice slices on the lattice,
    else incidence gathers."""
    lat = statics.lattice
    if lat is not None:
        return gather_tet_soa_lattice(tet_pos, lat.res, lat.tet_offsets)
    return gather_tet_soa(
        tet_pos, statics.tet_tx4,
        vert_tet_inc=(statics.vert_tet_inc_idx, statics.vert_tet_inc_mask))


def face_lattice_for(statics: GridStatics):
    """The class-major ``FaceLattice`` on the lattice, else None (the
    gather paths)."""
    return None if statics.lattice is None else statics.lattice.faces
