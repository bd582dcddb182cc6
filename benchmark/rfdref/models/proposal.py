"""Proposal module: vote aggregation + box parameter head.

Counterpart of `rfdnet_tpu/models/proposal.py` with `seed_fps`, the
configurations' way of choosing the cluster centres among the votes: FPS
over the seeds.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import furthest_point_sample
from .common import BatchNorm, Dense
from .pointnet2 import SetAbstraction


def decode_scores(net, aggregated_vote_xyz, num_heading_bin: int,
                  num_size_cluster: int) -> dict:
    """Split the head output (B, K, 2+3+NH*2+NS*4+NC) into end_points."""
    B, K, _ = net.shape
    nh, ns = num_heading_bin, num_size_cluster
    return {
        "objectness_scores": net[..., 0:2],
        "center": aggregated_vote_xyz + net[..., 2:5],
        "heading_scores": net[..., 5:5 + nh],
        "heading_residuals_normalized": net[..., 5 + nh:5 + nh * 2],
        "size_scores": net[..., 5 + nh * 2:5 + nh * 2 + ns],
        "size_residuals_normalized": net[
            ..., 5 + nh * 2 + ns:5 + nh * 2 + ns * 4].reshape(B, K, ns, 3),
        "sem_cls_scores": net[..., 5 + nh * 2 + ns * 4:],
    }


class ProposalModule(nn.Module):
    def __init__(self, num_class: int = 8, num_heading_bin: int = 12,
                 num_size_cluster: int = 8, num_proposal: int = 256,
                 seed_feat_dim: int = 256):
        super().__init__()
        self.num_class, self.num_proposal = num_class, num_proposal
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.vote_aggregation = SetAbstraction(
            num_proposal, 0.3, 16, seed_feat_dim, [128, 128, 128],
            normalize_xyz=True,
        )
        self.conv1 = Dense(128, 128)
        self.bn1 = BatchNorm(128)
        self.conv2 = Dense(128, 128)
        self.bn2 = BatchNorm(128)
        head = 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4 + num_class
        self.conv3 = Dense(128, head)

    def forward(self, xyz, features, end_points):
        """xyz (B, V, 3) votes, features (B, V, C) -> (end_points updates,
        proposal_features (B, K, 128))."""
        sample_inds = furthest_point_sample(
            end_points["seed_xyz"].detach().contiguous(), self.num_proposal)
        new_xyz, new_features, _ = self.vote_aggregation(
            xyz, features, inds=sample_inds)
        out = dict(end_points)
        out["aggregated_vote_xyz"] = new_xyz
        out["aggregated_vote_inds"] = sample_inds
        net = torch.relu(self.bn1(self.conv1(new_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        out.update(decode_scores(self.conv3(net), new_xyz,
                                 self.num_heading_bin, self.num_size_cluster))
        return out, new_features
