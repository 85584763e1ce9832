"""DeformableTetNetwork: two PVCNN encoders, the GCN position decoder and
the occupancy MLP (torch port of deftet_tpu/nn/model.py without the DISN
branch and the lap layer).

  * encode      — a voxel-feature pyramid per encoder (pos / occ);
  * decode_pos  — pyramid features at every lattice vertex ++ xyz ->
                  GCNMLPDecoder -> x0.1 -> sigmoid squash to (-0.1, 0.1)
                  -> boundary mask -> p + delta;
  * decode_occ  — features at pre-gathered tet centers -> MLP -> logits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.voxelize import trilinear_devoxelize
from .gcn import GCNMLPDecoder, LatticeAdjacency
from .mlp import MLPDecoder
from .pvcnn import DEFAULT_BLOCKS, PVCNNEncoder


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


def _lattice_interp_matrix(n_axis: int, grid_res: int, vox_res: int,
                           device) -> torch.Tensor:
    """(n_axis, vox_res) trilinear weights of lattice vertex i at voxel
    coordinate clip(i * r / res, 0, r - 1)."""
    c = np.clip(
        np.arange(n_axis) * vox_res / float(grid_res), 0.0, vox_res - 1.0
    )
    f = np.floor(c).astype(np.int64)
    t = c - f
    w = np.zeros((n_axis, vox_res), np.float32)
    w[np.arange(n_axis), f] += 1.0 - t
    w[np.arange(n_axis), np.minimum(f + 1, vox_res - 1)] += t
    return torch.as_tensor(w, device=device)


def sample_grid_features_lattice(pyramid: Sequence[torch.Tensor],
                                 grid_res: int, n_axis: int) -> torch.Tensor:
    """``sample_grid_features`` at ALL lattice vertices as three separable
    interpolation matmuls per level; (B, n_axis^3, sum C) in
    i n^2 + j n + k order."""
    feats = []
    for level in pyramid:
        r = level.shape[1]
        w = _lattice_interp_matrix(n_axis, grid_res, r, level.device)
        y = torch.einsum("xi,bijkc->bxjkc", w, level)
        y = torch.einsum("yj,bxjkc->bxykc", w, y)
        y = torch.einsum("zk,bxykc->bxyzc", w, y)
        feats.append(y.reshape(y.shape[0], n_axis**3, y.shape[-1]))
    return torch.cat(feats, dim=-1)


class DeformableTetNetwork(nn.Module):
    def __init__(
        self,
        blocks=DEFAULT_BLOCKS,
        use_two_encoder: bool = True,
        scale_pos: bool = True,
        scale_pvcnn: bool = True,
        train_def: bool = True,
        gcn_hidden: Sequence[int] = (256, 256, 128),
        pos_mlp_hidden: Sequence[float] = (128, 0.2, 64),
        occ_mlp_hidden: Sequence[float] = (256, 0.2, 256, 0.2, 128, 0.2, 64),
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_two_encoder = use_two_encoder
        self.scale_pos = scale_pos
        self.train_def = train_def
        g = generator
        self.encoder_pos = PVCNNEncoder(blocks, scale_pvcnn, dtype, g)
        if use_two_encoder:
            self.encoder_occ = PVCNNEncoder(blocks, scale_pvcnn, dtype, g)
        feat_dim = sum(c * nb for c, nb, _ in blocks) + 3
        self.decoder_pos = GCNMLPDecoder(feat_dim, tuple(gcn_hidden),
                                         tuple(pos_mlp_hidden), 3, dtype, g)
        self.decoder_occ = MLPDecoder(feat_dim, tuple(occ_mlp_hidden), 1,
                                      dtype, g)

    def encode(self, points_bxnx3: torch.Tensor, train: bool):
        """(pos pyramid, occ pyramid) of voxel features."""
        enc_pos = self.encoder_pos(points_bxnx3, train)
        enc_occ = (self.encoder_occ(points_bxnx3, train)
                   if self.use_two_encoder else enc_pos)
        return enc_pos, enc_occ

    def decode_pos(self, p_bxnx3, pyramid, pos_mask_bxnx3=None,
                   train: bool = True, adj: LatticeAdjacency | None = None,
                   lattice_res: int = 0,
                   generator: torch.Generator | None = None):
        """(pos_delta, tet_pos, ori_pos_delta).  ``lattice_res > 0``
        asserts that ``p`` is the undeformed res-``lattice_res`` vertex
        lattice, enabling the separable feature probe."""
        if not self.train_def:
            zero = torch.zeros_like(p_bxnx3)
            return zero, p_bxnx3, zero
        if adj is None:
            raise ValueError("decode_pos needs the lattice adjacency")
        if lattice_res > 0:
            feat = sample_grid_features_lattice(pyramid, lattice_res,
                                                lattice_res + 1)
        else:
            feat = sample_grid_features(p_bxnx3, pyramid)
        feat = torch.cat([feat, p_bxnx3], dim=-1)
        delta = self.decoder_pos(feat, adj, train, generator) * 0.1
        ori_delta = delta
        if self.scale_pos:
            delta = torch.sigmoid(delta) * 0.2 - 0.1
        if pos_mask_bxnx3 is not None:
            delta = delta * pos_mask_bxnx3
        return delta, p_bxnx3 + delta, ori_delta

    def decode_occ(self, centers_bxkx3, pyramid, train: bool = True,
                   generator: torch.Generator | None = None):
        """Bernoulli logits (B, K) at pre-gathered tet centers."""
        feat = sample_grid_features(centers_bxkx3, pyramid)
        feat = torch.cat([feat, centers_bxkx3], dim=-1)
        return self.decoder_occ(feat, train, generator)[..., 0]
