"""Networks: PVCNN encoders, GCN position decoder, occupancy MLP, the
DISN image branch."""

from .disn import DISNDecoder, DISNEncoder, VGG16Features
from .disn_port import inject_vgg16, load_vgg16_state_dict
from .gcn import (
    GCNMLPDecoder,
    GraphConv,
    GraphConvBlock,
    GraphConvLayer,
    LatticeAdjacency,
)
from .layers import BatchNorm, Conv3d, Dense
from .mlp import MLPDecoder
from .model import (
    DeformableTetNetwork,
    sample_grid_features,
    sample_grid_features_lattice,
)
from .pvcnn import PVCNNEncoder, PVConv, SharedMLP

__all__ = [
    "BatchNorm",
    "Conv3d",
    "DISNDecoder",
    "DISNEncoder",
    "DeformableTetNetwork",
    "Dense",
    "GCNMLPDecoder",
    "GraphConv",
    "GraphConvBlock",
    "GraphConvLayer",
    "LatticeAdjacency",
    "MLPDecoder",
    "PVCNNEncoder",
    "PVConv",
    "SharedMLP",
    "VGG16Features",
    "inject_vgg16",
    "load_vgg16_state_dict",
    "sample_grid_features",
    "sample_grid_features_lattice",
]
