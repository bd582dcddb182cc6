"""Torch models of ISCNet, in train and eval mode (torch's module mode)."""

from .backbone import Pointnet2Backbone
from .common import BatchNorm, Dense, MLPHead, SharedMLP, max_pool_points
from .iscnet import ISCNet
from .layers import (
    CBatchNorm,
    CResnetBlockConv1d,
    DecoderCBatchNorm,
    ResnetBlockFC,
    ResnetPointnet,
    SelfAttention,
)
from .occnet import ONet, make_3d_grid
from .pointnet2 import (
    FeaturePropagation,
    GroupSTN3d,
    SetAbstraction,
    SetAbstractionMSG,
    STNGroup,
)
from .pointseg import PointNetEncoder, PointSeg
from .proposal import ProposalModule, decode_scores
from .skip_propagation import SkipPropagation
from .voting import VotingModule

__all__ = [
    "BatchNorm", "CBatchNorm", "CResnetBlockConv1d", "DecoderCBatchNorm",
    "Dense", "FeaturePropagation", "GroupSTN3d", "ISCNet", "MLPHead", "ONet",
    "PointNetEncoder", "PointSeg", "Pointnet2Backbone", "ProposalModule",
    "ResnetBlockFC", "ResnetPointnet", "STNGroup", "SelfAttention",
    "SetAbstraction", "SetAbstractionMSG", "SharedMLP", "SkipPropagation", "VotingModule", "decode_scores",
    "make_3d_grid", "max_pool_points",
]
