"""Networks: PVCNN encoders, GCN position decoder, occupancy MLP, the
DISN image branch, and the PointNet modules (on no path, for the
inventory)."""

from .disn import DISNDecoder, DISNEncoder, VGG16Features
from .disn_port import inject_vgg16, load_vgg16_state_dict
from .gcn import (
    GCNMLPDecoder,
    GraphConv,
    GraphConvBlock,
    GraphConvLayer,
    LatticeAdjacency,
    VertexAdjacency,
)
from .layers import BatchNorm, Conv3d, Dense
from .mlp import MLPDecoder
from .model import (
    DeformableTetNetwork,
    sample_grid_features,
    sample_grid_features_lattice,
)
from .pointnet import (
    BallQueryGrouper,
    PointNetAModule,
    PointNetFPModule,
    PointNetSAModule,
)
from .pvcnn import PVCNNEncoder, PVConv, SharedMLP

__all__ = [
    "BallQueryGrouper",
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
    "PointNetAModule",
    "PointNetFPModule",
    "PointNetSAModule",
    "PVConv",
    "SharedMLP",
    "VGG16Features",
    "VertexAdjacency",
    "inject_vgg16",
    "load_vgg16_state_dict",
    "sample_grid_features",
    "sample_grid_features_lattice",
]
