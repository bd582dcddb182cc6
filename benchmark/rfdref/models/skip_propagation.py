"""Skip propagation: box proposal features back to scene points.

Counterpart of `rfdnet_tpu/models/skip_propagation.py` (`_run`,
`forward` with instance labels, `generate` without): group 1024 scene
points within r=1.0 of each proposal center, rotate into the box heading
frame, refine with the grouped STN, predict a per-point instance mask with
PointSeg, gate [xyz, height, box feature] by the argmax mask and encode
with ResnetPointnet to c_dim. With instance labels the predicted mask is
also scored against the proposal's instance (`pointseg_loss`): the mask
loss of training and of the Tester.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ResnetPointnet
from .pointnet2 import STNGroup
from .pointseg import PointSeg, pointseg_loss


class SkipPropagation(nn.Module):
    def __init__(self, c_dim: int = 512, hidden_dim: int = 512,
                 input_feature_dim: int = 1, box_feature_dim: int = 128):
        super().__init__()
        self.c_dim = c_dim
        self.input_feature_dim = input_feature_dim
        self.stn = STNGroup(radius=1.0, nsample=1024, normalize_xyz=True)
        self.encoder = ResnetPointnet(
            3 + input_feature_dim + box_feature_dim, c_dim, hidden_dim)
        self.point_seg = PointSeg(num_class=2, channel=3 + input_feature_dim)

    def _run(self, box_xyz, box_orientations, box_feature,
             input_point_cloud, point_instance_labels=None,
             proposal_instance_labels=None):
        """Returns (features (B, P, c_dim), mask loss or None).

        box_xyz (B, P, 3), box_orientations (B, P), box_feature
        (B, P, 128), input_point_cloud (B, N, 3+F), point_instance_labels
        (B, N) or None, proposal_instance_labels (B, P)."""
        xyz = input_point_cloud[..., 0:3]
        feat = input_point_cloud[..., 3:3 + self.input_feature_dim]
        # the instance-label channel, zeros without labels
        labels = (point_instance_labels[..., None]
                  if point_instance_labels is not None
                  else torch.zeros_like(feat[..., :1]))
        feat = torch.cat([feat, labels], dim=-1)
        grouped_xyz, grouped_features = self.stn(
            xyz, feat, box_xyz, box_orientations)
        B, P, S, _ = grouped_features.shape
        height = grouped_features[..., 0:1]
        input_features = torch.cat([grouped_xyz, height], dim=-1).reshape(
            B * P, S, -1)
        seg_pred, trans_feat = self.point_seg(input_features)
        seg_flat = seg_pred.reshape(B * P * S, 2)
        mask_loss = None
        if point_instance_labels is not None:
            target = (grouped_features[..., 1]
                      == proposal_instance_labels[..., None]).reshape(-1)
            mask_loss = pointseg_loss(seg_flat, target.long(), trans_feat)
        box_feat = box_feature.reshape(B * P, 1, -1).expand(
            -1, S, box_feature.shape[-1])
        input_features = torch.cat([input_features, box_feat], dim=-1)
        point_seg_mask = seg_flat.argmax(dim=-1).reshape(B * P, S, 1)
        input_features = input_features * point_seg_mask.float()
        return (self.encoder(input_features).reshape(B, P, self.c_dim),
                mask_loss)

    def forward(self, box_xyz, box_orientations, box_feature,
                input_point_cloud, point_instance_labels,
                proposal_instance_labels):
        """The supervised forward: (features, mask loss)."""
        return self._run(box_xyz, box_orientations, box_feature,
                         input_point_cloud, point_instance_labels,
                         proposal_instance_labels)

    def generate(self, box_xyz, box_orientations, box_feature,
                 input_point_cloud):
        """box_xyz (B, P, 3), box_orientations (B, P), box_feature
        (B, P, 128), input_point_cloud (B, N, 3+F) -> (B, P, c_dim)."""
        return self._run(box_xyz, box_orientations, box_feature,
                         input_point_cloud)[0]
