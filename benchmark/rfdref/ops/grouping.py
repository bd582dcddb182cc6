"""Point gathering and grouping, channels-last.

Counterpart of `rfdnet_tpu/ops/grouping.py` (`take_along_axis` there,
`torch.gather` here).
"""

from __future__ import annotations

import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) int -> (B, M, C)."""
    C = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, C))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) int -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points(features, idx.reshape(B, M * S)).reshape(B, M, S, -1)


def query_and_group(xyz, new_xyz, idx, features, *, radius: float,
                    use_xyz: bool = True, normalize_xyz: bool = False):
    """QueryAndGroup semantics, channels-last.

    xyz (B, N, 3), new_xyz (B, M, 3), idx (B, M, S) neighbour indices,
    features (B, N, C) or None -> (grouped (B, M, S, 3+C | C | 3),
    grouped_xyz (B, M, S, 3) center-relative, optionally / radius)."""
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is not None:
        grouped = group_points(features, idx)
        if use_xyz:
            grouped = torch.cat([grouped_xyz, grouped], dim=-1)
    else:
        if not use_xyz:
            raise ValueError("Cannot have no features and use_xyz=False")
        grouped = grouped_xyz
    return grouped, grouped_xyz
