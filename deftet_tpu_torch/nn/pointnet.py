"""PointNet set abstraction and feature propagation (torch port of
deftet_tpu/nn/pointnet.py): ``BallQueryGrouper``, ``PointNetAModule``,
``PointNetSAModule`` and ``PointNetFPModule``.

No path of either package builds these; they complete the inventory.  They
are built on the port's ``SharedMLP`` and named as flax names them
(``SharedMLP_0``, ``SharedMLP_1``, ...; the groupers hold no parameters),
so ``convert.load_flax_variables`` carries the JAX modules' variables
across.  Unlike flax, a torch module needs its input width up front:
each takes ``in_channels``, the width of the point features (0 for none).
Layouts are channels-last: features (B, N, C), coordinates (B, N, 3).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.sampling import (
    ball_query,
    furthest_point_sample,
    gather_points,
    grouping,
    three_nn_interpolate,
)
from .pvcnn import SharedMLP

__all__ = [
    "BallQueryGrouper",
    "PointNetAModule",
    "PointNetSAModule",
    "PointNetFPModule",
]


def _as_branch_channels(out_channels) -> Tuple[Tuple[int, ...], ...]:
    """One tuple of MLP widths per branch."""
    if not isinstance(out_channels, (list, tuple)):
        return ((int(out_channels),),)
    if not isinstance(out_channels[0], (list, tuple)):
        return (tuple(int(c) for c in out_channels),)
    return tuple(tuple(int(c) for c in branch) for branch in out_channels)


class BallQueryGrouper(nn.Module):
    """Neighbour features around each center: a fixed-radius ball query,
    the neighbours' coordinates re-centered on the center and, with
    ``include_coordinates``, put before the grouped features."""

    def __init__(self, radius: float, num_neighbors: int,
                 include_coordinates: bool = True):
        super().__init__()
        self.radius = float(radius)
        self.num_neighbors = int(num_neighbors)
        self.include_coordinates = include_coordinates

    def forward(self, points_coords, centers_coords, points_features=None):
        idx = ball_query(centers_coords, points_coords, self.radius,
                         self.num_neighbors)  # (B, M, U)
        neighbor_coords = (grouping(points_coords, idx)
                           - centers_coords[:, :, None, :])
        if points_features is None:
            if not self.include_coordinates:
                raise ValueError("no features to group")
            return neighbor_coords
        feats = grouping(points_features, idx)
        if self.include_coordinates:
            feats = torch.cat([neighbor_coords, feats], dim=-1)
        return feats  # (B, M, U, C[+3])


class PointNetAModule(nn.Module):
    """Global aggregation: a SharedMLP per branch over every point, max
    over the points.  Returns (features (B, 1, C), zero coordinates
    (B, 1, 3))."""

    def __init__(self, in_channels: int, out_channels: Union[int, Sequence],
                 include_coordinates: bool = True, dtype=None,
                 generator=None):
        super().__init__()
        self.include_coordinates = include_coordinates
        width = in_channels + (3 if include_coordinates else 0)
        self.branches = _as_branch_channels(out_channels)
        for i, branch in enumerate(self.branches):
            self.add_module(f"SharedMLP_{i}",
                            SharedMLP(width, branch, dtype, generator))

    def forward(self, features_bxnxc, coords_bxnx3, train: bool = True):
        x = features_bxnxc
        if self.include_coordinates:
            x = torch.cat([x, coords_bxnx3], dim=-1)
        outs = [torch.amax(getattr(self, f"SharedMLP_{i}")(x, train), dim=1,
                           keepdim=True)
                for i in range(len(self.branches))]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        zeros = torch.zeros((coords_bxnx3.shape[0], 1, 3),
                            dtype=coords_bxnx3.dtype,
                            device=coords_bxnx3.device)
        return out, zeros


class PointNetSAModule(nn.Module):
    """Set abstraction: ``num_centers`` FPS centers, a ball-query group
    per radius, a SharedMLP over (B, M, U, C), max over the neighbours;
    the branches concatenated.  Returns (features (B, M, C), centers)."""

    def __init__(self, in_channels: int, num_centers: int,
                 radius: Union[float, Sequence[float]],
                 num_neighbors: Union[int, Sequence[int]],
                 out_channels: Union[int, Sequence],
                 include_coordinates: bool = True, dtype=None,
                 generator=None):
        super().__init__()
        radii = list(radius) if isinstance(radius, (list, tuple)) \
            else [radius]
        neighbors = (list(num_neighbors)
                     if isinstance(num_neighbors, (list, tuple))
                     else [num_neighbors] * len(radii))
        branches = _as_branch_channels(out_channels)
        if len(branches) == 1 and len(radii) > 1:
            branches = branches * len(radii)
        if not len(radii) == len(neighbors) == len(branches):
            raise ValueError("one radius, neighbour count and MLP per "
                             "branch")
        self.num_centers = int(num_centers)
        self.n_branches = len(radii)
        width = in_channels + (3 if include_coordinates else 0)
        for i, (r, u, branch) in enumerate(zip(radii, neighbors, branches)):
            self.add_module(f"BallQueryGrouper_{i}", BallQueryGrouper(
                r, u, include_coordinates))
            self.add_module(f"SharedMLP_{i}",
                            SharedMLP(width, branch, dtype, generator))

    def forward(self, features_bxnxc, coords_bxnx3, train: bool = True):
        idx = furthest_point_sample(coords_bxnx3, self.num_centers)
        centers = gather_points(coords_bxnx3, idx)  # (B, M, 3)
        outs = []
        for i in range(self.n_branches):
            grouped = getattr(self, f"BallQueryGrouper_{i}")(
                coords_bxnx3, centers, features_bxnxc)
            y = getattr(self, f"SharedMLP_{i}")(grouped, train)
            outs.append(torch.amax(y, dim=2))  # (B, M, C)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return out, centers


class PointNetFPModule(nn.Module):
    """Feature propagation: the centers' features interpolated back to the
    points (3-NN), the points' own features after them, a SharedMLP.
    ``in_channels`` is the centers' plus the points' feature width.
    Returns (features (B, N, C), the points' coordinates)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 dtype=None, generator=None):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_channels,
                                     tuple(int(c) for c in out_channels),
                                     dtype, generator)

    def forward(self, points_coords, centers_coords, centers_features,
                points_features=None, train: bool = True):
        interp = three_nn_interpolate(points_coords, centers_coords,
                                      centers_features)
        if points_features is not None:
            interp = torch.cat([interp, points_features], dim=-1)
        return self.SharedMLP_0(interp, train), points_coords
