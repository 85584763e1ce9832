"""PVCNN point-voxel convolution encoder (torch port of
deftet_tpu/nn/pvcnn.py).

Point features are scatter-mean voxelized, pushed through two 3D convs
with BatchNorm (eps 1e-4) and LeakyReLU(0.1), trilinearly devoxelized
back to the points and fused with a per-point Dense+BN+ReLU.  Submodule
names follow flax's (``PVConv_0``, ``Conv_0``, ``BatchNorm_0``,
``SharedMLP_0``, ...) so converted parameters map one to one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxelize import avg_voxelize, trilinear_devoxelize
from .layers import BatchNorm, Conv3d, Dense

DEFAULT_BLOCKS: Tuple[Tuple[int, int, int], ...] = (
    (64, 1, 32),
    (128, 2, 16),
    (512, 1, 8),
)


def voxelize_coords(coords_bxnx3: torch.Tensor, resolution: int,
                    scale_pvcnn: bool = True):
    """(norm coords in [0, r-1], integer voxel coords) without gradient."""
    coords = coords_bxnx3.detach()
    if scale_pvcnn:
        norm = (coords + 1.0) / 2.0
    else:
        norm = coords - coords.mean(dim=1, keepdim=True)
        norm = (norm + 1.0) / 2.0
    norm = torch.clamp(norm * resolution, 0.0, resolution - 1.0)
    return norm, torch.round(norm).to(torch.int32)


class SharedMLP(nn.Module):
    """Per-point Dense + BatchNorm(eps 1e-5) + ReLU stack."""

    def __init__(self, in_features: int, features: Sequence[int], dtype=None,
                 generator=None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(in_features, f, dtype,
                                                generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(f, 1e-5, dtype=dtype))
            in_features = f

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x, train))
        return x


class PVConv(nn.Module):
    """One point-voxel block; returns (fused (B, N, C_out) f32, voxel
    features (B, R, R, R, C_out) f32)."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 scale_pvcnn: bool = True, dtype=None, generator=None):
        super().__init__()
        self.resolution = resolution
        self.scale_pvcnn = scale_pvcnn
        self.Conv_0 = Conv3d(in_channels, out_channels, 3, dtype, generator)
        self.BatchNorm_0 = BatchNorm(out_channels, 1e-4, dtype=dtype)
        self.Conv_1 = Conv3d(out_channels, out_channels, 3, dtype, generator)
        self.BatchNorm_1 = BatchNorm(out_channels, 1e-4, dtype=dtype)
        self.SharedMLP_0 = SharedMLP(in_channels, [out_channels], dtype,
                                     generator)

    def forward(self, features, coords, train: bool):
        norm, vox = voxelize_coords(coords, self.resolution, self.scale_pvcnn)
        v = avg_voxelize(features, vox, self.resolution)
        for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                         (self.Conv_1, self.BatchNorm_1)):
            v = F.leaky_relu(bn(conv(v), train), negative_slope=0.1)
        v = v.float()
        devox = trilinear_devoxelize(v, norm)
        point = self.SharedMLP_0(features, train).float()
        return devox + point, v


class PVCNNEncoder(nn.Module):
    """Stack of PVConv blocks; returns the per-block voxel pyramid.
    Points in [-0.5, 0.5]; features = coords = points * 2."""

    def __init__(self, blocks=DEFAULT_BLOCKS, scale_pvcnn: bool = True,
                 dtype=None, generator=None):
        super().__init__()
        self.n = 0
        in_c = 3
        for out_c, num_blocks, resolution in blocks:
            for _ in range(num_blocks):
                self.add_module(f"PVConv_{self.n}", PVConv(
                    in_c, out_c, resolution, scale_pvcnn, dtype, generator))
                self.n += 1
                in_c = out_c

    def forward(self, points_bxnx3: torch.Tensor, train: bool):
        features = points_bxnx3 * 2.0
        coords = features
        pyramid = []
        for i in range(self.n):
            features, vox = getattr(self, f"PVConv_{i}")(features, coords,
                                                         train)
            pyramid.append(vox)
        return pyramid
