"""DeformableTetNetwork: two encoders, the position decoder (with an
optional refinement head, the lap layer) and the occupancy decoder (torch
port of deftet_tpu/nn/model.py).

  * encode      — a voxel-feature pyramid per encoder (pos / occ) from
                  surface points; with ``use_disn`` a (global code, local
                  maps) pair per encoder from images;
  * decode_pos  — pyramid features at every lattice vertex ++ xyz ->
                  GCNMLPDecoder -> x0.1 -> sigmoid squash to (-0.1, 0.1)
                  -> boundary mask -> p + delta.  With ``use_lap_layer`` a
                  second head refines it from the probe of the UNDEFORMED
                  lattice (without xyz) ++ the refined positions, with the
                  same treatment; the first output is the whole
                  deformation delta + lap_delta.  With ``use_disn`` each
                  head is a DISNDecoder on camera-projected image features
                  (the lap head's at the refined positions);
  * decode_occ  — features at pre-gathered tet centers -> MLP (or a
                  DISNDecoder) -> logits.  Where no gradient is needed
                  the rows come from one ``grid_probe`` call (a kernel
                  on the card), else from the differentiable ATen probe.

The DISN paths open spans (``utils.timing``): ``disn.encode`` around
both image encoders (the input and map resizes included), and at every
head call ``disn.sample`` (the projection and the bilinear samples) and
``disn.decode`` (the head's MLPs).

Remat segments (``remat.segment``, inside ``remat.segmented``): the
probe and the first head's initial layer; the probe again with the lap
head's initial layer (recomputed rather than kept: the (B, N, 835)
float32 probe is 1.77 GB at res 50 / batch 4); each GCN block and each MLP
head; each DISN head.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import remat
from ..ops.grid_probe import grid_probe, needs_graph, sample_grid_features
from ..utils.timing import span
from .disn import DISNDecoder, DISNEncoder, disn_local_dim, \
    sample_image_features
from .gcn import GCNMLPDecoder
from .mlp import MLPDecoder
from .pvcnn import DEFAULT_BLOCKS, PVCNNEncoder


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
        use_lap_layer: bool = False,
        scale_pos: bool = True,
        scale_pvcnn: bool = True,
        train_def: bool = True,
        gcn_hidden: Sequence[int] = (256, 256, 128),
        pos_mlp_hidden: Sequence[float] = (128, 0.2, 64),
        occ_mlp_hidden: Sequence[float] = (256, 0.2, 256, 0.2, 128, 0.2, 64),
        dtype=None,
        use_disn: bool = False,
        disn_image_size: int = 64,
        disn_local_feature_size: int = 64,
        disn_encoding_dim: int = 1000,
        disn_width: float = 1.0,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_two_encoder = use_two_encoder
        self.use_lap_layer = use_lap_layer
        self.use_disn = use_disn
        self.scale_pos = scale_pos
        self.train_def = train_def
        g = generator
        if use_disn:
            def encoder():
                return DISNEncoder(disn_encoding_dim, disn_local_feature_size,
                                   image_size=disn_image_size,
                                   width=disn_width, generator=g)

            def decoder(out):
                return DISNDecoder(disn_encoding_dim,
                                   disn_local_dim(disn_width), out, g)

            self.encoder_pos = encoder()
            if use_two_encoder:
                self.encoder_occ = encoder()
            self.decoder_pos = decoder(3)
            self.decoder_occ = decoder(1)
            if use_lap_layer:
                self.lap_decoder_pos = decoder(3)
            return
        self.encoder_pos = PVCNNEncoder(blocks, scale_pvcnn, dtype, g)
        if use_two_encoder:
            self.encoder_occ = PVCNNEncoder(blocks, scale_pvcnn, dtype, g)
        feat_dim = sum(c * nb for c, nb, _ in blocks) + 3
        self.decoder_pos = GCNMLPDecoder(feat_dim, tuple(gcn_hidden),
                                         tuple(pos_mlp_hidden), 3, dtype, g)
        self.decoder_occ = MLPDecoder(feat_dim, tuple(occ_mlp_hidden), 1,
                                      dtype, g)
        if use_lap_layer:
            self.lap_decoder_pos = GCNMLPDecoder(
                feat_dim, tuple(gcn_hidden), tuple(pos_mlp_hidden), 3, dtype,
                g)

    def encoders(self):
        """The encoder modules (one, or pos and occ)."""
        return [self.encoder_pos] + (
            [self.encoder_occ] if self.use_two_encoder else [])

    def encode(self, inputs: torch.Tensor, train: bool):
        """(pos encoding, occ encoding): voxel pyramids of surface points
        (B, N, 3), or with ``use_disn`` (global, maps) of images (B, H, W,
        3)."""
        if self.use_disn:
            with span("disn.encode"):
                return self._encode(inputs, lambda enc: enc(inputs))
        return self._encode(inputs, lambda enc: enc(inputs, train))

    def _encode(self, inputs, run):
        enc_pos = run(self.encoder_pos)
        return enc_pos, (run(self.encoder_occ) if self.use_two_encoder
                         else enc_pos)

    def _squash(self, delta, pos_mask_bxnx3):
        """A head's x0.1 output squashed to (-0.1, 0.1) by a sigmoid, then
        masked."""
        if self.scale_pos:
            delta = torch.sigmoid(delta) * 0.2 - 0.1
        if pos_mask_bxnx3 is not None:
            delta = delta * pos_mask_bxnx3
        return delta

    @staticmethod
    def _disn_point_delta(decoder, p_bxnx3, encoding, cam_bx4x4):
        """A DISN head at the points: camera-projected local samples +
        the global code + xyz."""
        global_feat, maps = encoding
        if cam_bx4x4 is None:
            cam_bx4x4 = torch.eye(4, device=p_bxnx3.device).expand(
                p_bxnx3.shape[0], 4, 4)
        with span("disn.sample"):
            local = sample_image_features(maps, p_bxnx3, cam_bx4x4)
        with span("disn.decode"):
            return decoder(p_bxnx3, global_feat, local)

    def decode_pos(self, p_bxnx3, pyramid, pos_mask_bxnx3=None,
                   train: bool = True, adj=None, lattice_res: int = 0,
                   generator: torch.Generator | None = None,
                   cam_bx4x4: torch.Tensor | None = None):
        """(pos_delta, tet_pos, ori_pos_delta).  ``adj`` is the GCN's
        adjacency (nn.gcn: the lattice stencil or a VertexAdjacency).
        ``lattice_res > 0`` asserts that ``p`` is the undeformed
        res-``lattice_res`` vertex lattice, enabling the separable feature
        probe; at 0 each vertex is probed by trilinear interpolation.
        ``cam_bx4x4`` (the DISN camera) defaults to the identity."""
        if not self.train_def:
            zero = torch.zeros_like(p_bxnx3)
            return zero, p_bxnx3, zero
        if self.use_disn:
            # each head one remat segment, the lap head's at the refined
            # positions
            def head(decoder, p):
                return remat.segment(lambda: self._disn_point_delta(
                    decoder, p, pyramid, cam_bx4x4), decoder) * 0.1

            delta = head(self.decoder_pos, p_bxnx3)
            ori_delta = delta
            delta = self._squash(delta, pos_mask_bxnx3)
            pos = p_bxnx3 + delta
            if not self.use_lap_layer:
                return delta, pos, ori_delta
            lap_delta = self._squash(head(self.lap_decoder_pos, pos),
                                     pos_mask_bxnx3)
            return delta + lap_delta, pos + lap_delta, ori_delta
        if adj is None:
            raise ValueError("decode_pos needs the GCN's adjacency")

        # the pyramid probed at every vertex and a head's initial layer make
        # one remat segment, so the (B, N, 835) probe stays inside it
        def probe():
            if lattice_res > 0:
                return sample_grid_features_lattice(pyramid, lattice_res,
                                                    lattice_res + 1)
            return sample_grid_features(p_bxnx3, pyramid)

        x = remat.segment(lambda: self.decoder_pos.initial(
            torch.cat([probe(), p_bxnx3], dim=-1)))
        delta = self.decoder_pos.from_initial(x, adj, train, generator) * 0.1
        ori_delta = delta
        delta = self._squash(delta, pos_mask_bxnx3)
        pos = p_bxnx3 + delta
        if not self.use_lap_layer:
            return delta, pos, ori_delta
        # the refinement head: the probe of the undeformed lattice,
        # recomputed, ++ the refined positions
        head = self.lap_decoder_pos
        x = remat.segment(lambda: head.initial(
            torch.cat([probe(), pos], dim=-1)))
        lap_delta = self._squash(
            head.from_initial(x, adj, train, generator) * 0.1, pos_mask_bxnx3)
        # the first output is the whole deformation, so the regularizers
        # act on the whole field
        return delta + lap_delta, pos + lap_delta, ori_delta

    def decode_occ(self, centers_bxkx3, pyramid, train: bool = True,
                   generator: torch.Generator | None = None,
                   cam_bx4x4: torch.Tensor | None = None):
        """Bernoulli logits (B, K) at pre-gathered tet centers."""
        if self.use_disn:
            return self._disn_point_delta(self.decoder_occ, centers_bxkx3,
                                          pyramid, cam_bx4x4)[..., 0]
        if needs_graph(centers_bxkx3, pyramid):
            feat = torch.cat([sample_grid_features(centers_bxkx3, pyramid),
                              centers_bxkx3], dim=-1)
        else:
            # no graph: the rows in one pass, already in the dtype the
            # decoder's first layer computes in
            feat = grid_probe(centers_bxkx3, pyramid, True,
                              self.decoder_occ.input_dtype(
                                  centers_bxkx3.dtype))
        return self.decoder_occ(feat, train, generator)[..., 0]
