"""Dense, 3D convolution, BatchNorm and dropout with the JAX package's
(flax) semantics, in PyTorch.

* Parameters are float32; a module's compute ``dtype`` (None or
  torch.bfloat16) casts inputs and parameters before the matmul or conv,
  as flax's ``dtype=`` does, and the bias is added to the product after
  it is rounded to that dtype, as flax adds it (so a bf16 network rounds
  where the JAX package's does).
* Activations stay channels-last; ``Conv3d`` takes (B, X, Y, Z, C).
* ``BatchNorm`` normalizes over every axis but the last, with float32
  statistics and the BIASED batch variance ``E[x^2] - E[x]^2`` (clipped
  at 0), and updates its running statistics as
  ``momentum * running + (1 - momentum) * batch`` with flax's
  ``momentum=0.9`` (torch's convention would call that 0.1).  Under a
  data-parallel shard (``parallel.sharded``) the statistics are those of
  the global batch, so the running statistics stay equal on every rank.
* ``dropout`` draws its mask per example: under a shard, this rank's rows
  of the mask the one-process step draws.
* Initialization follows flax: truncated LeCun-normal kernels, zero
  biases, unit BatchNorm scales; every draw comes from the caller's
  ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel

# stddev correction of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _compute_dtype(dtype, x: torch.Tensor, w: torch.Tensor):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Module):
    """y = x W^T + b on the last axis; ``weight`` is (out, in).  With
    ``use_bias=False`` there is no ``bias`` parameter (flax's
    ``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 generator=None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)
        _lecun_normal_(self.weight.data, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        y = F.linear(x.to(dt), self.weight.to(dt))
        # the bias is added to the product rounded to dt, as flax adds it
        return y if self.bias is None else y + self.bias.to(dt)


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
                     self.weight.to(dt), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1) + self.bias.to(dt)


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
        # two conversions to float32, as flax makes them (one for the
        # statistics, one for x - mean): a bf16 x then gets the two parts
        # of its gradient rounded to bf16 apart, then summed, as in JAX
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean, ex2 = global_moments(xf.mean(dim=axes),
                                       (xf * xf).mean(dim=axes))
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * (torch.rsqrt(var + self.epsilon)
                                  * self.weight)
        y = y + self.bias
        return y.to(self.dtype if self.dtype is not None else y.dtype)


def global_moments(mean: torch.Tensor, ex2: torch.Tensor):
    """(E[x], E[x^2]) of the global batch from this rank's: the mean of
    the ranks' moments, differentiable (a one-rank group is the identity,
    bit for bit); themselves in one process."""
    if parallel.active() is None:
        return mean, ex2
    both = parallel.mean_over_shard(torch.stack([mean, ex2]),
                                    differentiable=True)
    return both[0], both[1]


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """jax.nn.leaky_relu: ``where(x >= 0, x, slope * x)`` with the slope
    rounded to x's dtype, as JAX rounds a Python scalar (torch's own
    multiplies by the float32 slope, another bf16 product).  The rounded
    slope stays a Python number: no host-to-device copy."""
    slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return torch.where(x >= 0, x, x * slope)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as JAX lowers it (there is no HLO logistic op):
    ``1 / (1 + exp(-x))`` in x's dtype, so a bf16 x is rounded after the
    exp, the add and the division (torch's own sigmoid rounds once); its
    gradient is JAX's rule ``g * (y * (1 - y))``, rounded at each op."""
    return _Sigmoid.apply(x)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate); the identity outside training."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = parallel.draw_rows(x.shape, lambda shape: torch.rand(
        shape, generator=generator, device=x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
