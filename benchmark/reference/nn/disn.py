"""DefTet's single-view image network, the DISN branch, written plainly:
two VGG-16 (configuration D) image encoders, one for positions and one
for occupancy, and a DISN head for each, summing a global and a local
SDF branch.  Sources: DISN (Xu et al., arXiv:1905.10711) as DefTet wires
it (github.com/nv-tlabs/DefTet: ``layers/disn.py``, ``pc_model.py``
73-111, ``DISNEncoder(image_size=64)``); VGG-16 D (arXiv:1409.1556).

* Encoder: images (B, H, W, 3) resized to ``image_size`` (antialiased
  bilinear), ImageNet-normalized, 13 3x3 convolutions (64 to 512 wide,
  ReLU, a 2x2 max pool after each stage) and a classifier of 4,096,
  4,096 and ``encoding_dim``: the global code.  The five pre-pool maps
  (64 + 128 + 256 + 512 + 512 channels at full width), each resized to
  ``local_size``, are the local features.
* Head: each query point is projected by the view's 4x4 row-vector
  camera ((xyz, 1) @ M, then xy / z) and every map is sampled there
  bilinearly with zero padding.  A global branch and a local branch each
  run a point MLP (64, 256, 512), concatenate the global code or the
  local samples, run (512, 256) and a Dense to the output; the two are
  summed.
* Network: the position head's output x 0.1, squashed by a sigmoid to
  (-0.1, 0.1) and masked, displaces every lattice vertex; the occupancy
  head's is the logit at the sampled tet centres.

Departures from the published networks, as DefTet's port computes them:

* the classifier reads the last conv map (2 x 2 at 64 px) resized
  bilinearly to 7 x 7, where torchvision's VGG takes an adaptive average
  pool, and flattens it in (h, w, c) order, where torchvision flattens
  (c, h, w): a real VGG checkpoint reaches the first classifier layer
  with its inputs permuted (random weights here, so no checkpoint);
* the input is resized to 64 px and the local maps to 64 x 64 (DISN
  feeds 137-px images and upsamples its maps to 137);
* a width factor scales every conv and the classifier's hidden width
  (1.0 here: the published widths).

Everything computes in float32 (``steps_disn`` turns TF32 off).  The
state-dict names are the port's, so one set of weights loads into both.
``dtype=torch.bfloat16`` computes every convolution and Dense in
bfloat16 (the control that has to fail the comparison);
``global_only=True`` drops the local branch (a planted fault).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

VGG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
POINT_MLP = (64, 256, 512)
COND_MLP = (512, 256)


def vgg_widths(width: float):
    """(the 13 conv widths, the classifier's hidden width) of VGG-D
    scaled by ``width`` (at least 8 and 16)."""
    convs = [max(int(v * width), 8) for v in VGG_D if v != "M"]
    return convs, max(int(4096 * width), 16)


def local_dim(width: float) -> int:
    """Channels of the five pre-pool maps together."""
    convs, _ = vgg_widths(width)
    return sum(convs[i] for i in (1, 3, 6, 9, 12))


def resize(x_bxcxhxw: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize to (size, size); unchanged where the
    size is already that."""
    if tuple(x_bxcxhxw.shape[-2:]) == (size, size):
        return x_bxcxhxw
    return F.interpolate(x_bxcxhxw, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def _cast(t, dtype):
    return t if dtype is None else t.to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer`` in float32, or with its inputs and weights in ``dtype``;
    float32 out."""
    return F.linear(_cast(x, dtype), _cast(layer.weight, dtype),
                    _cast(layer.bias, dtype)).float()


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.conv2d(_cast(x, dtype), _cast(layer.weight, dtype),
                    _cast(layer.bias, dtype), padding=1).float()


class VGG16(nn.Module):
    """VGG-D: (global code (B, D), the five pre-pool maps)."""

    def __init__(self, encoding_dim: int, width: float):
        super().__init__()
        convs, hidden = vgg_widths(width)
        c_in = 3
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", nn.Conv2d(c_in, c, 3, padding=1))
            c_in = c
        self.Dense_0 = nn.Linear(c_in * 49, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, encoding_dim)

    def forward(self, x, dtype=None):
        maps, i = [], 0
        for v in VGG_D:
            if v == "M":
                maps.append(x)
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(conv(getattr(self, f"Conv_{i}"), x, dtype))
                i += 1
        x = resize(x, 7).permute(0, 2, 3, 1).flatten(1)
        x = F.relu(linear(self.Dense_0, x, dtype))
        x = F.relu(linear(self.Dense_1, x, dtype))
        return linear(self.Dense_2, x, dtype), maps


class Encoder(nn.Module):
    """Images (B, H, W, 3) in [0, 1] -> (global code, local maps)."""

    def __init__(self, encoding_dim: int, image_size: int, local_size: int,
                 width: float):
        super().__init__()
        self.image_size, self.local_size = image_size, local_size
        self.VGG16Features_0 = VGG16(encoding_dim, width)

    def forward(self, images_bxhxwx3, dtype=None):
        x = resize(images_bxhxwx3.float().permute(0, 3, 1, 2),
                   self.image_size)
        mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
        std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
        code, maps = self.VGG16Features_0((x - mean) / std, dtype)
        return code, [resize(m, self.local_size) for m in maps]


def project(points_bxnx3, cam_bx4x4):
    """Screen xy in [-1, 1]: ((xyz, 1) @ M)[:2] / its z."""
    homo = torch.cat([points_bxnx3, torch.ones_like(points_bxnx3[..., :1])],
                     dim=-1)
    proj = homo @ cam_bx4x4
    return proj[..., :2] / proj[..., 2:3]


def sample(maps, xy_bxnx2):
    """Every map sampled bilinearly at xy ((-1, -1) the top-left corner,
    pixel centres at half steps, zero outside): (B, N, sum C)."""
    grid = xy_bxnx2[:, :, None, :]
    return torch.cat([F.grid_sample(m, grid, mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=False)[..., 0]
                      .transpose(1, 2) for m in maps], dim=-1)


class MLP(nn.Module):
    def __init__(self, in_dim: int, dims):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, d))
            in_dim = d

    def forward(self, x, dtype, last_relu: bool = True):
        for i in range(self.n):
            x = linear(getattr(self, f"Dense_{i}"), x, dtype)
            if last_relu or i < self.n - 1:
                x = F.relu(x)
        return x


class Branch(nn.Module):
    """Point MLP, the condition concatenated, MLP, Dense to ``out``."""

    def __init__(self, cond_dim: int, out: int):
        super().__init__()
        self._PointMLP_0 = MLP(3, POINT_MLP)
        self._PointMLP_1 = MLP(POINT_MLP[-1] + cond_dim, COND_MLP)
        self._PointMLP_2 = MLP(COND_MLP[-1], (out,))

    def forward(self, q_bxnx3, cond_bxnxd, dtype):
        x = self._PointMLP_0(q_bxnx3, dtype)
        x = self._PointMLP_1(torch.cat([x, cond_bxnxd], dim=-1), dtype)
        return self._PointMLP_2(x, dtype, last_relu=False)


class Head(nn.Module):
    """The global branch on the code, plus the local branch on the local
    samples unless they are None."""

    def __init__(self, encoding_dim: int, local: int, out: int):
        super().__init__()
        self.SDFGlobalDecoder_0 = Branch(encoding_dim, out)
        self.SDFLocalDecoder_0 = Branch(local, out)

    def forward(self, q_bxnx3, code_bxd, local_bxnxd, dtype=None):
        code = code_bxd[:, None, :].expand(-1, q_bxnx3.shape[1], -1)
        out = self.SDFGlobalDecoder_0(q_bxnx3, code, dtype)
        if local_bxnxd is None:
            return out
        return out + self.SDFLocalDecoder_0(q_bxnx3, local_bxnxd, dtype)


class DISNNetwork(nn.Module):
    """The DISN network with the interface ``train.step`` drives:
    ``encoders``, ``encode``, ``decode_pos``, ``decode_occ`` and
    ``decoder_occ``."""

    def __init__(self, encoding_dim: int = 1000, image_size: int = 64,
                 local_size: int = 64, width: float = 1.0,
                 use_two_encoder: bool = True, scale_pos: bool = True,
                 train_def: bool = True, dtype=None,
                 global_only: bool = False):
        super().__init__()
        self.use_two_encoder, self.scale_pos = use_two_encoder, scale_pos
        self.train_def, self.dtype = train_def, dtype
        self.global_only = global_only

        def encoder():
            return Encoder(encoding_dim, image_size, local_size, width)

        self.encoder_pos = encoder()
        if use_two_encoder:
            self.encoder_occ = encoder()
        self.decoder_pos = Head(encoding_dim, local_dim(width), 3)
        self.decoder_occ = Head(encoding_dim, local_dim(width), 1)

    def encoders(self):
        return [self.encoder_pos] + (
            [self.encoder_occ] if self.use_two_encoder else [])

    def encode(self, images_bxhxwx3, train: bool = True):
        pos = self.encoder_pos(images_bxhxwx3, self.dtype)
        return pos, (self.encoder_occ(images_bxhxwx3, self.dtype)
                     if self.use_two_encoder else pos)

    def _head(self, head: Head, q_bxnx3, encoding, cam_bx4x4):
        code, maps = encoding
        local = (None if self.global_only else
                 sample(maps, project(q_bxnx3, cam_bx4x4)))
        return head(q_bxnx3, code, local, self.dtype)

    def decode_pos(self, p_bxnx3, encoding, pos_mask_bxnx3=None,
                   train: bool = True, adj=None, lattice_res: int = 0,
                   generator=None, cam_bx4x4=None):
        """(delta, deformed positions, delta before the squash)."""
        if not self.train_def:
            zero = torch.zeros_like(p_bxnx3)
            return zero, p_bxnx3, zero
        raw = self._head(self.decoder_pos, p_bxnx3, encoding, cam_bx4x4) * 0.1
        delta = torch.sigmoid(raw) * 0.2 - 0.1 if self.scale_pos else raw
        if pos_mask_bxnx3 is not None:
            delta = delta * pos_mask_bxnx3
        return delta, p_bxnx3 + delta, raw

    def decode_occ(self, centers_bxkx3, encoding, train: bool = True,
                   generator=None, cam_bx4x4=None):
        """Logits (B, K) at the tet centres."""
        return self._head(self.decoder_occ, centers_bxkx3, encoding,
                          cam_bx4x4)[..., 0]
