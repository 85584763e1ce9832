"""The pyramid probe at points: every level of a voxel-feature pyramid
sampled at clamp((p + 0.5) r, 0, r - 1) with border trilinear
interpolation, the levels side by side (torch port of
deftet_tpu/nn/model.py's ``sample_grid_features``).

``sample_grid_features`` is the differentiable probe in ATen ops (the
JAX package's expressions: per level and corner a gather, a multiply and
an add).  ``grid_probe`` builds the occupancy decoder's input rows where
no gradient is needed: on a CUDA tensor one launch of
``csrc/grid_probe.cu`` writes each row once, with the points' xyz
appended and rounded to the dtype asked for; on a CPU tensor it runs
``grid_probe_plain``, the same rows from ``sample_grid_features``.  Both
agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _cuda
from .voxelize import trilinear_devoxelize

_KERNEL = "grid_probe"
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 16  # kMaxLevels in csrc/grid_probe.cu


def sample_grid_features(point_pos_bxnx3: torch.Tensor,
                         pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Probe every pyramid level at clamp((p + 0.5) r, 0, r - 1) with
    border trilinear interpolation; (B, N, sum C)."""
    p01 = point_pos_bxnx3 + 0.5
    feats = []
    for level in pyramid:
        r = level.shape[1]
        coords = torch.clamp(p01 * r, 0.0, r - 1.0)
        feats.append(trilinear_devoxelize(level, coords))
    return torch.cat(feats, dim=-1)


def needs_graph(points_bxnx3: torch.Tensor,
                pyramid: Sequence[torch.Tensor]) -> bool:
    """Whether autograd would record the probe: grad mode is on and the
    points or a level require grad."""
    return torch.is_grad_enabled() and (
        points_bxnx3.requires_grad
        or any(level.requires_grad for level in pyramid))


def grid_probe_plain(points_bxnx3: torch.Tensor,
                     pyramid: Sequence[torch.Tensor], append_points: bool,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``grid_probe``: (B, n, sum C [+ 3])."""
    feat = sample_grid_features(points_bxnx3, pyramid)
    if append_points:
        feat = torch.cat([feat, points_bxnx3], dim=-1)
    return feat.to(out_dtype)


def _level_args(level: torch.Tensor, b: int, device):
    """(level with unit-stride (r^3, C) rows, r, C, batch stride, floats a
    load) as the kernel reads it; raises on what it does not take."""
    if (level.dim() != 5 or level.shape[0] != b
            or level.shape[1] != level.shape[2]
            or level.shape[1] != level.shape[3] or level.shape[1] == 0
            or level.shape[4] == 0):
        raise ValueError("grid_probe needs (B, r, r, r, C) levels beside "
                         f"(B, n, 3) points, got {tuple(level.shape)} for "
                         f"B = {b}")
    if level.dtype != torch.float32 or level.device != device:
        raise ValueError("grid_probe needs float32 levels on the points' "
                         f"device, got {level.dtype} on {level.device}")
    r, c = level.shape[1], level.shape[4]
    if r**3 >= 2**31:
        raise ValueError(f"grid_probe: a level of {r}^3 voxels is too large")
    if level.stride()[1:] != (r * r * c, r * c, c, 1):
        level = level.contiguous()
    bstride = level.stride(0) if b > 1 else 0
    vec = 1
    for v in (4, 2):
        if c % v == 0 and bstride % v == 0 and \
                level.data_ptr() % (4 * v) == 0:
            vec = v
            break
    return level, r, c, bstride, vec


def _grid_probe_cuda(points_bxnx3, pyramid, append_points, out_dtype):
    if points_bxnx3.dim() != 3 or points_bxnx3.shape[-1] != 3 or \
            points_bxnx3.dtype != torch.float32:
        raise ValueError("grid_probe needs (B, n, 3) float32 points, got "
                         f"{tuple(points_bxnx3.shape)} {points_bxnx3.dtype}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"grid_probe writes float32 or bfloat16, not "
                         f"{out_dtype}")
    if len(pyramid) > MAX_LEVELS:
        raise ValueError(f"grid_probe takes at most {MAX_LEVELS} levels")
    b, n, _ = points_bxnx3.shape
    dev = points_bxnx3.device
    levels = [_level_args(level, b, dev) for level in pyramid]
    cols, col = [], 0
    for _, _, c, _, _ in levels:
        cols.append(col)
        col += c
    ncols = col + (3 if append_points else 0)
    out = torch.empty((b, n, ncols), dtype=out_dtype, device=dev)
    if b * n == 0 or ncols == 0:
        return out
    if b * n >= 2**31 or n >= 2**31:
        raise ValueError(f"grid_probe: {b} x {n} rows are too many")
    lib = _cuda.library(_KERNEL)
    k = len(levels)
    data = (ctypes.c_void_p * max(k, 1))(*(lv[0].data_ptr() for lv in levels))
    bstrides = (ctypes.c_longlong * max(k, 1))(*(lv[3] for lv in levels))
    rs = (ctypes.c_int * max(k, 1))(*(lv[1] for lv in levels))
    cs = (ctypes.c_int * max(k, 1))(*(lv[2] for lv in levels))
    col_arr = (ctypes.c_int * max(k, 1))(*cols)
    vecs = (ctypes.c_int * max(k, 1))(*(lv[4] for lv in levels))
    pstrides = (ctypes.c_longlong * 3)(*points_bxnx3.stride())
    with torch.cuda.device(dev):
        err = lib.deftet_grid_probe(
            data, bstrides, rs, cs, col_arr, vecs, k,
            points_bxnx3.data_ptr(), pstrides, b, n, ncols,
            int(append_points), _OUT_KINDS[out_dtype], out.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check(lib, err, _KERNEL)
    _cuda.count_launch(_KERNEL)
    return out


def grid_probe(points_bxnx3: torch.Tensor, pyramid: Sequence[torch.Tensor],
               append_points: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The rows ``cat([sample_grid_features(p, pyramid), p], -1)`` (without
    ``p`` unless ``append_points``) in ``out_dtype``, bit for bit, with no
    gradient: raises where autograd would need a graph.  A CUDA tensor
    launches the kernel (float32 points and levels; float32 or bfloat16
    rows); a CPU tensor runs ``grid_probe_plain``."""
    if needs_graph(points_bxnx3, pyramid):
        raise RuntimeError("grid_probe has no backward: call it under "
                           "torch.no_grad() or on tensors that need no "
                           "gradient (sample_grid_features is the "
                           "differentiable probe)")
    if points_bxnx3.device.type == "cuda":
        return _grid_probe_cuda(points_bxnx3, pyramid, append_points,
                                out_dtype)
    if points_bxnx3.device.type == "cpu":
        return grid_probe_plain(points_bxnx3, pyramid, append_points,
                                out_dtype)
    raise RuntimeError(f"no grid probe for {points_bxnx3.device}")
