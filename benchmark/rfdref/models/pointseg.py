"""PointNet instance segmentation head (per-point mask) and its loss.

Counterpart of `rfdnet_tpu/models/pointseg.py`: input STN3d (3x3), feature
STNkd (64x64), seg head 1088 -> 512 -> 256 -> 128 -> 2 with log-softmax;
`pointseg_loss` (NLL + the feature transform's orthogonality penalty).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BatchNorm, Dense, max_pool_points


class _STN(nn.Module):
    """STN3d / STNkd trunk: per-point MLP 64-128-1024, max-pool, FC
    512-256-k*k, + identity. x (B, N, in_features) -> (B, k, k)."""

    def __init__(self, k: int, in_features: int):
        super().__init__()
        self.k = k
        dims = [in_features, 64, 128, 1024, 512, 256]
        for i in range(3):
            self.add_module(f"conv{i + 1}", Dense(dims[i], dims[i + 1]))
            self.add_module(f"bn{i + 1}", BatchNorm(dims[i + 1]))
        for i in range(2):
            self.add_module(f"fc{i + 1}", Dense(dims[i + 3], dims[i + 4]))
            self.add_module(f"bn{i + 4}", BatchNorm(dims[i + 4]))
        self.fc3 = Dense(256, k * k)

    def forward(self, x):
        h = x
        for i in range(1, 4):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        h = max_pool_points(h, dim=1)
        for i in range(1, 3):
            h = torch.relu(getattr(self, f"bn{i + 3}")(getattr(self, f"fc{i}")(h)))
        iden = torch.eye(self.k, dtype=torch.float32, device=h.device).reshape(-1)
        return (self.fc3(h) + iden).reshape(x.shape[0], self.k, self.k)


class PointNetEncoder(nn.Module):
    """global_feat=False, feature_transform=True: x (B, N, channel) ->
    (per-point features (B, N, 1088), trans_feat (B, 64, 64))."""

    def __init__(self, channel: int = 4):
        super().__init__()
        self.channel = channel
        self.stn = _STN(3, channel)
        self.conv1 = Dense(channel, 64)
        self.bn1 = BatchNorm(64)
        self.fstn = _STN(64, 64)
        self.conv2 = Dense(64, 128)
        self.bn2 = BatchNorm(128)
        self.conv3 = Dense(128, 1024)
        self.bn3 = BatchNorm(1024)

    def forward(self, x):
        # STN3d reads every channel but transforms xyz only
        trans = self.stn(x)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if self.channel > 3 else xyz
        h = torch.relu(self.bn1(self.conv1(x)))
        trans_feat = self.fstn(h)
        pointfeat = torch.bmm(h, trans_feat)
        h = torch.relu(self.bn2(self.conv2(pointfeat)))
        h = self.bn3(self.conv3(h))
        glob = max_pool_points(h, dim=1, keepdim=True).expand(-1, h.shape[1], -1)
        return torch.cat([glob, pointfeat], dim=-1), trans_feat


class PointSeg(nn.Module):
    """Per-point segmentation: x (B, N, channel) -> (log_probs (B, N,
    num_class), trans_feat)."""

    def __init__(self, num_class: int = 2, channel: int = 4):
        super().__init__()
        self.feat = PointNetEncoder(channel)
        dims = [1088, 512, 256, 128]
        for i in range(3):
            self.add_module(f"conv{i + 1}", Dense(dims[i], dims[i + 1]))
            self.add_module(f"bn{i + 1}", BatchNorm(dims[i + 1]))
        self.conv4 = Dense(128, num_class)

    def forward(self, x):
        h, trans_feat = self.feat(x)
        for i in range(1, 4):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        return torch.log_softmax(self.conv4(h), dim=-1), trans_feat


def feature_transform_regularizer(trans):
    """The orthogonality penalty of the feature transform, as the reference
    computes it: bmm(A, A^T - I) (the -I before the product), its
    Frobenius norm per item, then the mean over the batch."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    prod = torch.bmm(trans, trans.transpose(1, 2) - eye)
    norms = torch.linalg.matrix_norm(prod)
    return torch.sum(norms) / norms.numel()


def pointseg_loss(log_probs, target, trans_feat, mat_diff_loss_scale=0.001):
    """NLL + 0.001 x orthogonality penalty. log_probs (M, C), target (M,)
    integer -> scalar."""
    per = -torch.gather(log_probs, 1, target[:, None].long())[:, 0]
    nll = torch.sum(per) / per.numel()
    reg = feature_transform_regularizer(trans_feat)
    return nll + reg * mat_diff_loss_scale
