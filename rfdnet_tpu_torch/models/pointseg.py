"""PointNet instance segmentation head (per-point mask) and its loss.

Counterpart of `rfdnet_tpu/models/pointseg.py`: input STN3d (3x3), feature
STNkd (64x64), seg head 1088 -> 512 -> 256 -> 128 -> 2 with log-softmax;
`pointseg_loss` (NLL + the feature transform's orthogonality penalty).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BatchNorm, Dense, max_pool_points
from ..collectives import global_sum


class _STN(nn.Module):
    """STN3d / STNkd trunk: per-point MLP 64-128-1024, max-pool, FC
    512-256-k*k, + identity. x (B, N, in_features) -> (B, k, k)."""

    F32_HEADS = ("fc3",)   # the transform stays f32 in a bf16 chain

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
        # the 64 x 64 transform's product accumulates in f32
        pointfeat = torch.bmm(h.float(), trans_feat).to(h.dtype)
        h = torch.relu(self.bn2(self.conv2(pointfeat)))
        h = self.bn3(self.conv3(h))
        glob = max_pool_points(h, dim=1, keepdim=True).expand(-1, h.shape[1], -1)
        return torch.cat([glob, pointfeat], dim=-1), trans_feat


class PointSeg(nn.Module):
    """Per-point segmentation: x (B, N, channel) -> (log_probs (B, N,
    num_class), trans_feat)."""

    F32_HEADS = ("conv4",)   # the class logits stay f32 in a bf16 chain

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


def _mean(x, weights=None, group=None):
    """The mean of x (weighted by `weights` when given), over the global
    batch of `group` when given (`collectives.global_sum`)."""
    if weights is None:
        return torch.sum(x) / global_sum(x.numel(), group)
    return torch.sum(x * weights) / torch.clamp(
        global_sum(torch.sum(weights), group), min=1e-6)


def feature_transform_regularizer(trans, weights=None, group=None):
    """The orthogonality penalty of the feature transform, as the reference
    computes it: bmm(A, A^T - I) (the -I before the product), its
    Frobenius norm per item, then the mean over the batch (weighted by
    `weights` (B,) when given)."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    prod = torch.bmm(trans, trans.transpose(1, 2) - eye)
    return _mean(torch.linalg.matrix_norm(prod), weights, group)


def pointseg_loss(log_probs, target, trans_feat, mat_diff_loss_scale=0.001,
                  sample_weights=None, trans_weights=None, group=None):
    """NLL + 0.001 x orthogonality penalty. log_probs (M, C), target (M,)
    integer -> scalar. sample_weights (M,) / trans_weights (B,): weighted
    means that leave out padded proposal slots. `group`: the global
    batch's means (`collectives.global_sum`)."""
    per = -torch.gather(log_probs, 1, target[:, None].long())[:, 0]
    nll = _mean(per, sample_weights, group)
    reg = feature_transform_regularizer(trans_feat, trans_weights, group)
    return nll + reg * mat_diff_loss_scale
