"""PointNet++ backbone: 4 SA + 2 FP layers -> 1024 seeds x 256-d.

Counterpart of `rfdnet_tpu/models/backbone.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from .pointnet2 import FeaturePropagation, SetAbstraction


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 1):
        super().__init__()
        self.input_feature_dim = input_feature_dim
        kw = dict(normalize_xyz=True)
        self.sa1 = SetAbstraction(2048, 0.2, 64, input_feature_dim,
                                  [64, 64, 128], **kw)
        self.sa2 = SetAbstraction(1024, 0.4, 32, 128, [128, 128, 256], **kw)
        self.sa3 = SetAbstraction(512, 0.8, 16, 256, [128, 128, 256], **kw)
        self.sa4 = SetAbstraction(256, 1.2, 16, 256, [128, 128, 256], **kw)
        self.fp1 = FeaturePropagation(256 + 256, [256, 256])
        self.fp2 = FeaturePropagation(256 + 256, [256, 256])

    def forward(self, pointcloud):
        """pointcloud (B, N, 3 + input_feature_dim) -> end_points with the
        fp2 (seed) xyz/features/inds and every sa*_xyz/features."""
        xyz = pointcloud[..., 0:3]
        features = (pointcloud[..., 3:3 + self.input_feature_dim]
                    if pointcloud.shape[-1] > 3 else None)
        ep = {}
        xyz, features, ep["sa1_inds"] = self.sa1(xyz, features)
        ep["sa1_xyz"], ep["sa1_features"] = xyz, features
        xyz, features, ep["sa2_inds"] = self.sa2(xyz, features)
        ep["sa2_xyz"], ep["sa2_features"] = xyz, features
        xyz, features, _ = self.sa3(xyz, features)
        ep["sa3_xyz"], ep["sa3_features"] = xyz, features
        xyz, features, _ = self.sa4(xyz, features)
        ep["sa4_xyz"], ep["sa4_features"] = xyz, features

        features = self.fp1(ep["sa3_xyz"], ep["sa4_xyz"], ep["sa3_features"],
                            ep["sa4_features"])
        features = self.fp2(ep["sa2_xyz"], ep["sa3_xyz"], ep["sa2_features"],
                            features)
        ep["fp2_features"] = features
        ep["fp2_xyz"] = ep["sa2_xyz"]
        # seed indices into the original cloud: sa2 sampled sa1's output
        ep["fp2_inds"] = torch.gather(ep["sa1_inds"], 1,
                                      ep["sa2_inds"].long())
        return ep
