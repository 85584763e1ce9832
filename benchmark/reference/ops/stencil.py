"""K1: the 14-offset lattice stencil (row-normalized neighbour mean).

Replaces deftet_tpu/ops/stencil_pallas.py:_stencil3d_kernel, reached there
via ``stencil_sum`` and the custom-VJP ``lattice_neighbor_mean``.

    out[b, v, c] = scale[v] * sum_{off} r(x[b, v + off, c] * in_scale[v + off])

over the n^3 vertex lattice (vertex v = i n^2 + j n + k); reads outside the
lattice are zero, r() rounds to x's dtype, accumulation is f32 and storage
keeps x's dtype.  The offset set is symmetric, so the un-normalized
stencil is self-transpose and the VJP of ``inv_deg * S(x)`` is
``S(r(inv_deg * g))``: the same kernel with ``in_scale = inv_deg`` on the
cotangent, one launch and no elementwise pass.

In this frozen copy every device runs ``stencil_sum_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F



def _check(x: torch.Tensor, n: int, offsets, scale, in_scale) -> None:
    if x.dim() != 3 or x.shape[1] != n**3:
        raise ValueError(f"x must be (B, {n}^3, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not all(len(o) == 3 and all(-1 <= d <= 1 for d in o)
               for o in offsets):
        raise ValueError(f"offsets must lie in {{-1,0,1}}^3: {offsets}")
    for name, t in (("scale", scale), ("in_scale", in_scale)):
        if t is None:
            continue
        if t.shape != (n**3,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape (n^3,)")
        if t.device != x.device:
            raise ValueError(f"{name} and x must be on one device")


def stencil_sum_plain(x: torch.Tensor, n: int, offsets,
                      scale: torch.Tensor | None = None,
                      in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: scale x by in_scale (rounded to x's dtype),
    zero-pad the lattice and sum the 14 shifted slices in offset order
    (f32), then scale and cast to x's dtype."""
    b, v, c = x.shape
    if in_scale is not None:
        x = (x.float() * in_scale[None, :, None]).to(x.dtype)
    xp = F.pad(x.reshape(b, n, n, n, c).float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, n, n, n, c), dtype=torch.float32, device=x.device)
    for di, dj, dk in offsets:
        acc = acc + xp[:, 1 + di:1 + di + n, 1 + dj:1 + dj + n,
                       1 + dk:1 + dk + n]
    out = acc.reshape(b, v, c)
    if scale is not None:
        out = out * scale[None, :, None]
    return out.to(x.dtype)


def stencil_sum(x: torch.Tensor, n: int, offsets,
                scale: torch.Tensor | None = None,
                in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``scale * sum_off shift_off(r(in_scale * x))`` over the n^3
    lattice; (B, n^3, C) in x's dtype.  CUDA tensors go to the kernel, CPU
    tensors to the plain version; anything else raises."""
    offsets = tuple(tuple(int(d) for d in o) for o in offsets)
    _check(x, n, offsets, scale, in_scale)
    return stencil_sum_plain(x, n, offsets, scale, in_scale)


class StencilMean(torch.autograd.Function):
    """Row-normalized neighbour mean ``inv_deg * S(x)`` with the
    self-transpose backward ``S(r(inv_deg * g))`` in x's dtype, the
    cotangent's pre-scale read inside the kernel."""

    @staticmethod
    def forward(ctx, x, inv_deg, n, offsets):
        ctx.save_for_backward(inv_deg)
        ctx.n = n
        ctx.offsets = offsets
        return stencil_sum(x.contiguous(), n, offsets, inv_deg)

    @staticmethod
    def backward(ctx, g):
        (inv_deg,) = ctx.saved_tensors
        return (stencil_sum(g.contiguous(), ctx.n, ctx.offsets,
                            in_scale=inv_deg), None, None, None)


def lattice_neighbor_mean(x: torch.Tensor, inv_deg: torch.Tensor, n: int,
                          offsets) -> torch.Tensor:
    """Row-normalized adjacency matmul on the regular lattice (K1)."""
    return StencilMean.apply(x, inv_deg, n, offsets)
