"""Hough voting: per-seed MLP predicting xyz offsets and residual features.

Counterpart of `rfdnet_tpu/models/voting.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BatchNorm, Dense


class VotingModule(nn.Module):
    def __init__(self, vote_factor: int = 1, in_dim: int = 256):
        super().__init__()
        self.vote_factor, self.in_dim = vote_factor, in_dim
        self.conv1 = Dense(in_dim, in_dim)
        self.bn1 = BatchNorm(in_dim)
        self.conv2 = Dense(in_dim, in_dim)
        self.bn2 = BatchNorm(in_dim)
        self.conv3 = Dense(in_dim, (3 + in_dim) * vote_factor)

    def forward(self, seed_xyz, seed_features):
        """seed_xyz (B, S, 3), seed_features (B, S, C) -> (vote_xyz
        (B, S*vote_factor, 3), vote_features (B, S*vote_factor, C))."""
        B, S, _ = seed_xyz.shape
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).reshape(B, S, self.vote_factor, 3 + self.in_dim)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(
            B, S * self.vote_factor, 3)
        vote_features = (seed_features[:, :, None, :] + net[..., 3:]).reshape(
            B, S * self.vote_factor, self.in_dim)
        return vote_xyz, vote_features
