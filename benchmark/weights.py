"""The run's weights, made from the seed on the device: the benchmark's
own initialisation, handed to the program and to the reference alike.

Kernels (every parameter of two or more axes) are LeCun-normal, cut at
two standard deviations (the port's flax-style scheme); BatchNorm scales
are 1, biases 0, running means 0 and running variances 1.  All kernels
come from one draw of a device generator, split and scaled leaf by leaf.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut to [-2, 2]


def seeded_state(names_shapes, seed: int, device) -> dict:
    """{name: tensor} for ``names_shapes`` ((name, shape) of a module's
    parameters and buffers, in state-dict order), from ``seed``."""
    names_shapes = [(n, tuple(s)) for n, s in names_shapes]
    kernels = [(n, s) for n, s in names_shapes if len(s) >= 2]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in names_shapes:
        if len(shape) >= 2:
            n = math.prod(shape)
            std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
            out[name] = (flat[at:at + n] * std).view(shape)
            at += n
        elif name.endswith("running_var") or (
                name.endswith("weight") and "BatchNorm" in name):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
