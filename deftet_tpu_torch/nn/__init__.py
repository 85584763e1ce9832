"""Networks: PVCNN encoders, GCN position decoder, occupancy MLP."""

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
    "sample_grid_features",
    "sample_grid_features_lattice",
]
