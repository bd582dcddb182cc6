"""PointNet++ set abstraction / feature propagation and the grouped STN,
channels-last.

Counterpart of `rfdnet_tpu/models/pointnet2.py`: `SetAbstraction`
(max pooling), `FeaturePropagation`, `GroupSTN3d`, `STNGroup`. Torch
layers need their input widths, which flax infers; each constructor takes
them. FPS samples a detached copy of the points: no gradient flows
through the choice of samples, as the JAX package's `stop_gradient`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    interpolate_features,
    query_and_group,
)
from .common import BatchNorm, Dense, SharedMLP, max_pool_points


class SetAbstraction(nn.Module):
    """PointnetSAModuleVotes with max pooling. `in_features` is the width
    of the point features (0 for none)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: Sequence[int], use_xyz: bool = True,
                 normalize_xyz: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.normalize_xyz = use_xyz, normalize_xyz
        self.mlp = SharedMLP(in_features + 3 * use_xyz, mlp)

    def forward(self, xyz, features, inds=None):
        """xyz (B, N, 3), features (B, N, C) | None -> (new_xyz (B, np, 3),
        new_features (B, np, mlp[-1]), inds (B, np))."""
        if inds is None:
            inds = furthest_point_sample(xyz.detach().contiguous(),
                                         self.npoint)
        new_xyz = gather_points(xyz, inds)
        idx = ball_query(xyz, new_xyz, self.radius, self.nsample)
        grouped, _ = query_and_group(
            xyz, new_xyz, idx, features, radius=self.radius,
            use_xyz=self.use_xyz, normalize_xyz=self.normalize_xyz,
        )
        return new_xyz, max_pool_points(self.mlp(grouped), dim=2), inds


class FeaturePropagation(nn.Module):
    """PointnetFPModule: inverse-distance 3-NN interpolation of the coarse
    features, concatenated with the skip features, then a shared MLP."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        new = interpolate_features(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            new = torch.cat([new, unknown_feats], dim=-1)
        return self.mlp(new)


class GroupSTN3d(nn.Module):
    """12-parameter (3x4 affine) transformer over grouped xyz,
    (B, P, S, 3) -> (B, P, S, 3). The FC stack is zero-initialised, so the
    transform starts as the identity."""

    def __init__(self):
        super().__init__()
        dims = [3, 64, 128, 256]
        for i in range(3):
            self.add_module(f"conv{i + 1}", Dense(dims[i], dims[i + 1]))
            self.add_module(f"bn{i + 1}", BatchNorm(dims[i + 1]))
        self.fc1 = Dense(256, 128, zero_init=True)
        self.bn4 = BatchNorm(128)
        self.fc2 = Dense(128, 64, zero_init=True)
        self.bn5 = BatchNorm(64)
        self.fc3 = Dense(64, 12, zero_init=True)

    def forward(self, grouped_xyz):
        B, P, S, _ = grouped_xyz.shape
        x = grouped_xyz.reshape(B * P, S, 3)
        h = x
        for i in range(1, 4):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        h = max_pool_points(h, dim=1)
        h = torch.relu(self.bn4(self.fc1(h)))
        h = torch.relu(self.bn5(self.fc2(h)))
        iden = torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                            dtype=torch.float32, device=h.device)
        h = (self.fc3(h) + iden).reshape(B * P, 3, 4)
        rot, t = h[:, :, :3], h[:, :, 3]
        # x' = A[:, :3] @ x + A[:, 3] with column vectors
        out = torch.einsum("bij,bsj->bsi", rot, x) + t[:, None, :]
        return out.reshape(B, P, S, 3)


class STNGroup(nn.Module):
    """Gather nsample points within radius of each proposal center, rotate
    them into the box's heading frame, refine with `GroupSTN3d`."""

    def __init__(self, radius: float = 1.0, nsample: int = 1024,
                 normalize_xyz: bool = True):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.normalize_xyz = normalize_xyz
        self.stn3d = GroupSTN3d()

    def forward(self, xyz, features, new_xyz, orientations):
        """xyz (B, N, 3), features (B, N, C), new_xyz (B, P, 3) centers,
        orientations (B, P) -> (grouped_xyz (B, P, ns, 3),
        grouped_features (B, P, ns, C))."""
        idx = ball_query(xyz, new_xyz, self.radius, self.nsample)
        grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        grouped_features = group_points(features, idx)
        c = torch.cos(orientations)[..., None]
        s = torch.sin(orientations)[..., None]
        # R rows: [cos, sin, 0; -sin, cos, 0; 0, 0, 1]
        x, y, z = grouped_xyz.unbind(-1)
        grouped_xyz = torch.stack([c * x + s * y, -s * x + c * y, z], dim=-1)
        return self.stn3d(grouped_xyz), grouped_features
