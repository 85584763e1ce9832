"""DISN image branch: a VGG-16 feature-pyramid encoder and the global +
local SDF decoders (torch port of deftet_tpu/nn/disn.py).

  * VGG16Features  — the VGG-D conv stack; returns the global image
                     encoding (an adaptive 7x7 resize and three Dense
                     layers) and the five pre-maxpool feature maps;
  * DISNEncoder    — optional image resize, ImageNet normalization, VGG,
                     each map resized to ``local_feature_size``;
  * sample_image_features — project query points by a 4x4 row-vector
                     camera matrix and sample every map bilinearly with
                     zero padding;
  * SDFGlobalDecoder / SDFLocalDecoder / DISNDecoder — a point MLP (64,
    256, 512), the global code or the local samples concatenated, an MLP
    (512, 256) and a Dense to the output; DISNDecoder sums the two.

Layouts: images arrive channels-last (B, H, W, 3) as in the JAX package;
the convolutions and the feature maps are channels-first (B, C, H, W),
and the classifier head permutes to (B, 7, 7, C) before it flattens, so
that its first Dense reads the (h, w, c) order of the JAX package's
flatten.  Every module computes in float32 whatever the network's
precision, as the JAX package's do.  The module names are the flax
auto-names (``VGG16Features_0.Conv_0``, ``SDFGlobalDecoder_0._PointMLP_1
.Dense_0``, ...), so ``convert.flax_to_state_dict`` maps every leaf.

Resizes are ``F.interpolate(mode="bilinear", antialias=True)``:
``jax.image.resize(method="linear")`` antialiases when it downsamples,
and leaves a dimension of unchanged size as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _lecun_normal_

# VGG-16 configuration "D": conv widths with "M" for a 2x2 max pool.
_VGG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_linear(x_bxcxhxw: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., method="linear")`` to (size, size) on a
    channels-first map: antialiased bilinear, the identity where the size
    does not change."""
    if tuple(x_bxcxhxw.shape[-2:]) == (size, size):
        return x_bxcxhxw
    return F.interpolate(x_bxcxhxw, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class Conv2d(nn.Module):
    """3x3 convolution with padding 1 (flax ``nn.Conv(c, (3, 3),
    padding=1)``); ``weight`` is (out, in, 3, 3), flax's kernel (3, 3, in,
    out) permuted."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _lecun_normal_(self.weight.data, in_channels * 9, generator)

    def forward(self, x_bxcxhxw: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x_bxcxhxw, self.weight, self.bias, padding=1)


def vgg_widths(width: float):
    """(conv widths, classifier hidden width) of a ``width``-scaled VGG-D."""
    convs = [max(int(int(v) * width), 8) for v in _VGG_D if v != "M"]
    return convs, max(int(4096 * width), 16)


class VGG16Features(nn.Module):
    """VGG-D conv stack; ``forward`` returns (global encoding (B, D),
    [pre-pool maps (B, C, H, W)])."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 generator=None):
        super().__init__()
        convs, hidden = vgg_widths(width)
        c_in = 3
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", Conv2d(c_in, c, generator))
            c_in = c
        self.n_convs = len(convs)
        self.Dense_0 = Dense(c_in * 49, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, hidden, generator=generator)
        self.Dense_2 = Dense(hidden, num_classes, generator=generator)

    def forward(self, x_bxcxhxw: torch.Tensor):
        x = x_bxcxhxw
        maps = []
        i = 0
        for v in _VGG_D:
            if v == "M":
                maps.append(x)
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        # flatten in (h, w, c) order, as the JAX package's NHWC head does
        x = resize_linear(x, 7).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x), maps


class DISNEncoder(nn.Module):
    """Images (B, H, W, 3) -> (global (B, D), [maps (B, C, s, s)])."""

    def __init__(self, image_encoding_dim: int = 1000,
                 local_feature_size: int = 137, normalize: bool = True,
                 image_size: int | None = None, width: float = 1.0,
                 generator=None):
        super().__init__()
        self.local_feature_size = local_feature_size
        self.normalize = normalize
        self.image_size = image_size
        self.VGG16Features_0 = VGG16Features(image_encoding_dim, width,
                                             generator)

    def forward(self, images_bxhxwx3: torch.Tensor):
        x = images_bxhxwx3.float().permute(0, 3, 1, 2)
        if self.image_size is not None:
            x = resize_linear(x, self.image_size)
        if self.normalize:
            mean = x.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
            std = x.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
            x = (x - mean) / std
        global_feat, maps = self.VGG16Features_0(x)
        s = self.local_feature_size
        return global_feat, [resize_linear(m, s) for m in maps]


def project_points(points_bxnx3: torch.Tensor,
                   camera_matrix_bx4x4: torch.Tensor) -> torch.Tensor:
    """Row-vector projection to [-1, 1] screen space: (homo @ M)[:2] / z,
    in float32 (the JAX package's matmul runs at HIGHEST precision)."""
    p = points_bxnx3.float()
    homo = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    proj = torch.matmul(homo, camera_matrix_bx4x4.float())
    return proj[..., :2] / proj[..., 2:3]


def bilinear_sample(map_bxcxhxw: torch.Tensor,
                    xy_bxnx2: torch.Tensor) -> torch.Tensor:
    """(B, N, C) bilinear samples with zero padding at xy in [-1, 1],
    (-1, -1) the top-left corner (the JAX package's four-tap gather with
    align_corners=False).  ``grid_sample`` computes the same function and
    keeps no per-tap (B, N, C) tensors for its backward."""
    out = F.grid_sample(map_bxcxhxw, xy_bxnx2[:, :, None, :],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[..., 0].transpose(1, 2)


def sample_image_features(maps: Sequence[torch.Tensor],
                          points_bxnx3: torch.Tensor,
                          camera_matrix_bx4x4: torch.Tensor) -> torch.Tensor:
    """Every local map sampled at the projected points, concatenated on
    the channel axis: (B, N, sum C)."""
    xy = project_points(points_bxnx3, camera_matrix_bx4x4)
    return torch.cat([bilinear_sample(m, xy) for m in maps], dim=-1)


class _PointMLP(nn.Module):
    def __init__(self, in_dim: int, dims: Sequence[int], final: bool = False,
                 generator=None):
        super().__init__()
        self.n = len(dims)
        self.final = final
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", Dense(in_dim, d,
                                                generator=generator))
            in_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if not (self.final and i == self.n - 1):
                x = F.relu(x)
        return x


class SDFGlobalDecoder(nn.Module):
    def __init__(self, global_dim: int, out_features: int = 1,
                 generator=None):
        super().__init__()
        g = generator
        self._PointMLP_0 = _PointMLP(3, (64, 256, 512), generator=g)
        self._PointMLP_1 = _PointMLP(512 + global_dim, (512, 256),
                                     generator=g)
        self._PointMLP_2 = _PointMLP(256, (out_features,), final=True,
                                     generator=g)

    def forward(self, query_bxnx3, global_bxd):
        x = self._PointMLP_0(query_bxnx3)
        g = global_bxd[:, None, :].expand(-1, x.shape[1], -1)
        x = self._PointMLP_1(torch.cat([x, g], dim=-1))
        return self._PointMLP_2(x)


class SDFLocalDecoder(nn.Module):
    def __init__(self, local_dim: int, out_features: int = 1,
                 generator=None):
        super().__init__()
        g = generator
        self._PointMLP_0 = _PointMLP(3, (64, 256, 512), generator=g)
        self._PointMLP_1 = _PointMLP(512 + local_dim, (512, 256),
                                     generator=g)
        self._PointMLP_2 = _PointMLP(256, (out_features,), final=True,
                                     generator=g)

    def forward(self, query_bxnx3, local_bxnxd):
        x = self._PointMLP_0(query_bxnx3)
        x = self._PointMLP_1(torch.cat([x, local_bxnxd], dim=-1))
        return self._PointMLP_2(x)


class DISNDecoder(nn.Module):
    """The global and the local SDF predictions, summed."""

    def __init__(self, global_dim: int, local_dim: int, out_features: int = 1,
                 generator=None):
        super().__init__()
        self.SDFGlobalDecoder_0 = SDFGlobalDecoder(global_dim, out_features,
                                                   generator)
        self.SDFLocalDecoder_0 = SDFLocalDecoder(local_dim, out_features,
                                                 generator)

    def forward(self, query_bxnx3, global_bxd, local_bxnxd):
        return (self.SDFGlobalDecoder_0(query_bxnx3, global_bxd)
                + self.SDFLocalDecoder_0(query_bxnx3, local_bxnxd))


def disn_local_dim(width: float) -> int:
    """Channels of the concatenated local maps: the width of each conv
    stage's last layer (the map taken before each pool)."""
    convs, _ = vgg_widths(width)
    return sum(convs[i] for i in (1, 3, 6, 9, 12))


__all__ = [
    "DISNDecoder",
    "DISNEncoder",
    "SDFGlobalDecoder",
    "SDFLocalDecoder",
    "VGG16Features",
    "bilinear_sample",
    "disn_local_dim",
    "project_points",
    "resize_linear",
    "sample_image_features",
]
