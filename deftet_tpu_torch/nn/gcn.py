"""Graph-convolutional vertex-offset decoder (torch port of
deftet_tpu/nn/gcn.py, lattice path).

  GraphConv      — self_filter(x) + filter(adj @ x)
  GraphConvLayer — relu applied BEFORE the conv
  GraphConvBlock — two layers + linear shortcut residual
  GCNMLPDecoder  — Dense(in -> h0) -> blocks over gcn_hidden -> MLP head
                   -> Dense(3)

On the regular Kuhn lattice ``adj @ x`` is the 14-offset stencil, K1
(ops.stencil), at every width: the JAX package's ``c >= 64`` and
``stencil_fits_vmem`` gates were TPU layout and VMEM choices, not part of
the function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stencil import lattice_neighbor_mean
from .layers import BatchNorm, Dense, dropout


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeAdjacency:
    """Row-normalized vertex adjacency of a regular tet lattice as a
    shift stencil: ``offsets`` are the 14 neighbour offsets in
    {-1, 0, 1}^3, ``inv_deg`` (n^3,) float32 is 1 / true degree."""

    offsets: tuple
    inv_deg: torch.Tensor
    n: int

    @classmethod
    def from_degree(cls, offsets, degree: torch.Tensor) -> "LatticeAdjacency":
        n_verts = degree.shape[0]
        n = round(n_verts ** (1.0 / 3.0))
        while n**3 < n_verts:
            n += 1
        if n**3 != n_verts:
            raise ValueError(f"{n_verts} vertices do not form a cube lattice")
        inv_deg = 1.0 / torch.clamp(degree, min=1).to(torch.float32)
        return cls(tuple(tuple(int(d) for d in o) for o in offsets),
                   inv_deg, n)

    def matmul(self, x_bxnxd: torch.Tensor) -> torch.Tensor:
        return lattice_neighbor_mean(x_bxnxd, self.inv_deg, self.n,
                                     self.offsets)


class GraphConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype=None, generator=None):
        super().__init__()
        self.self_filter = Dense(in_dim, out_dim, dtype, generator)
        self.filter = Dense(in_dim, out_dim, dtype, generator)

    def forward(self, x, adj: LatticeAdjacency):
        return self.self_filter(x) + self.filter(adj.matmul(x))


class GraphConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype=None, generator=None):
        super().__init__()
        self.GraphConv_0 = GraphConv(in_dim, out_dim, dtype, generator)

    def forward(self, x, adj: LatticeAdjacency):
        return self.GraphConv_0(F.relu(x), adj)


class GraphConvBlock(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype=None, generator=None):
        super().__init__()
        self.GraphConvLayer_0 = GraphConvLayer(in_dim, hidden_dim, dtype,
                                               generator)
        self.GraphConvLayer_1 = GraphConvLayer(hidden_dim, out_dim, dtype,
                                               generator)
        self.shortcut = (Dense(in_dim, out_dim, dtype, generator)
                         if in_dim != out_dim else None)

    def forward(self, x, adj: LatticeAdjacency):
        net = self.GraphConvLayer_0(x, adj)
        dx = self.GraphConvLayer_1(net, adj)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + dx


class GCNMLPDecoder(nn.Module):
    """GCN + MLP head producing per-vertex outputs (f32)."""

    def __init__(self, in_dim: int,
                 gcn_hidden: Sequence[int] = (256, 256, 128),
                 mlp_hidden: Sequence[float] = (128, 0.2, 64),
                 out_dim: int = 3, dtype=None, generator=None):
        super().__init__()
        self.initial = Dense(in_dim, gcn_hidden[0], dtype, generator)
        self.n_blocks = len(gcn_hidden) - 1
        for i in range(self.n_blocks):
            self.add_module(f"GraphConvBlock_{i}", GraphConvBlock(
                gcn_hidden[i], gcn_hidden[i], gcn_hidden[i + 1], dtype,
                generator))
        width = gcn_hidden[-1]
        self.plan = []
        j = 0
        for h in mlp_hidden:
            if h < 1:
                self.plan.append(("dropout", float(h)))
                continue
            self.add_module(f"Dense_{j}", Dense(width, int(h), dtype,
                                                generator))
            self.add_module(f"BatchNorm_{j}", BatchNorm(int(h), 1e-5,
                                                        dtype=dtype))
            self.plan.append(("dense", j))
            width = int(h)
            j += 1
        self.head = Dense(width, out_dim, dtype, generator)

    def forward(self, feat, adj: LatticeAdjacency, train: bool,
                generator: torch.Generator | None = None):
        x = self.initial(feat)
        for i in range(self.n_blocks):
            x = getattr(self, f"GraphConvBlock_{i}")(x, adj)
        for kind, arg in self.plan:
            if kind == "dropout":
                x = dropout(x, arg, train, generator)
            else:
                x = getattr(self, f"Dense_{arg}")(x)
                x = F.relu(getattr(self, f"BatchNorm_{arg}")(x, train))
        return self.head(x).float()
