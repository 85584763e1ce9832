"""Offline VGG-16 weights for the DISN encoder: a torchvision VGG-16 state
dict injected into one encoder's ``VGG16Features_0`` (torch port of
deftet_tpu/nn/disn_port.py).  Nothing is downloaded; random
initialization stays the default.

    # anywhere with torchvision:
    #   torch.save(torchvision.models.vgg16(weights="IMAGENET1K_V1")
    #              .state_dict(), "vgg16.pth")
    state = load_vgg16_state_dict("vgg16.pth")
    inject_vgg16(model, state, encoder="encoder_pos")

The 13 convolutions and the 3 classifier layers map one to one: the
port's Conv2d and Dense keep torchvision's layouts.  ``classifier.0``'s
weight maps as it stands, as the JAX package maps it (a plain transpose
into flax's kernel): torchvision flattens the 7x7 head input in (c, h, w)
order and both packages flatten it in (h, w, c), so a real checkpoint
reaches ``Dense_0`` with its 25,088 inputs permuted.  Kept, so that one
checkpoint gives both packages the same function.  Needs disn_width=1.0
and disn_encoding_dim=1000 (the torchvision head) unless the checkpoint
is width-scaled the same way.
"""

from __future__ import annotations

from typing import Dict

import torch

# torchvision vgg16 state-dict indices of the 13 convs and 3 linears
_TORCH_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_TORCH_FC_IDS = (0, 3, 6)


def load_vgg16_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch-saved VGG-16 state dict from a local file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def vgg16_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision keys -> ``VGG16Features`` keys (``Conv_i.weight`` ...,
    ``Dense_j.bias``), float32."""
    out = {}
    for i, tid in enumerate(_TORCH_CONV_IDS):
        for leaf in ("weight", "bias"):
            out[f"Conv_{i}.{leaf}"] = state[f"features.{tid}.{leaf}"].float()
    for i, tid in enumerate(_TORCH_FC_IDS):
        for leaf in ("weight", "bias"):
            out[f"Dense_{i}.{leaf}"] = \
                state[f"classifier.{tid}.{leaf}"].float()
    return out


def load_vgg16_params(path: str) -> Dict[str, torch.Tensor]:
    """``VGG16Features``' state dict from a torch-saved torchvision VGG-16
    (the JAX package's function of this name returns its flax params)."""
    return vgg16_state_dict(load_vgg16_state_dict(path))


def inject_vgg16(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                 encoder: str = "encoder_pos") -> None:
    """Copy a torchvision VGG-16 state dict into ``model.<encoder>``'s
    VGG, in place; every shape is checked against the model's first."""
    enc = getattr(model, encoder, None)
    vgg = getattr(enc, "VGG16Features_0", None)
    if vgg is None:
        raise KeyError(f"no VGG under {encoder!r}: is use_disn on?")
    target = vgg.state_dict()
    ported = vgg16_state_dict(state)
    for key, value in ported.items():
        if key not in target:
            raise KeyError(f"{key} missing in model (width-scaled VGG?)")
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{encoder}.{key}: checkpoint {tuple(value.shape)} != model "
                f"{tuple(target[key].shape)} (need disn_width=1.0, "
                f"disn_encoding_dim=1000)")
    with torch.no_grad():
        for key, value in ported.items():
            target[key].copy_(value)
