"""Dense, 3D convolution, BatchNorm and dropout with the JAX package's
(flax) semantics, in PyTorch.

* Parameters are float32; a module's compute ``dtype`` (None or
  torch.bfloat16) casts inputs and parameters before the matmul or conv,
  as flax's ``dtype=`` does.
* Activations stay channels-last; ``Conv3d`` takes (B, X, Y, Z, C).
* ``BatchNorm`` normalizes over every axis but the last, with float32
  statistics and the BIASED batch variance ``E[x^2] - E[x]^2`` (clipped
  at 0), and updates its running statistics as
  ``momentum * running + (1 - momentum) * batch`` with flax's
  ``momentum=0.9`` (torch's convention would call that 0.1).
* Initialization follows flax: truncated LeCun-normal kernels, zero
  biases, unit BatchNorm scales; every draw comes from the caller's
  ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# stddev correction of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _compute_dtype(dtype, x: torch.Tensor, w: torch.Tensor):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Module):
    """y = x W^T + b on the last axis; ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        _lecun_normal_(self.weight.data, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv3d(nn.Module):
    """'SAME'-padded 3D convolution on channels-last voxels; ``weight`` is
    (out, in, k, k, k) (flax stores (k, k, k, in, out): permuted, not
    flipped — both cross-correlate)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.padding = k // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _lecun_normal_(self.weight.data, in_channels * k**3, generator)

    def forward(self, x_bxrc: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x_bxrc, self.weight)
        y = F.conv3d(x_bxrc.permute(0, 4, 1, 2, 3).to(dt),
                     self.weight.to(dt), self.bias.to(dt),
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over all axes but the last (see module doc)."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.weight)
        y = y + self.bias
        return y.to(self.dtype if self.dtype is not None else y.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate); the identity outside training."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
