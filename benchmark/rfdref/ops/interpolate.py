"""Three-NN feature interpolation (PointNet++ FP layers).

Counterpart of `rfdnet_tpu/ops/interpolate.py`. The JAX package takes
`lax.top_k` of the negated squared distances, which keeps the lower index
first on ties; a stable ascending sort does the same here (`torch.topk`
promises no order for ties).
"""

from __future__ import annotations

import torch


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, n, 3), known (B, m, 3) -> (dist (B, n, 3) euclidean,
    idx (B, n, 3) int64) of the 3 nearest known points."""
    unknown = unknown.float()
    known = known.float()
    u2 = (unknown * unknown).sum(-1)
    k2 = (known * known).sum(-1)
    d2 = u2[..., None] + k2[:, None, :] - 2.0 * torch.bmm(
        unknown, known.transpose(1, 2))
    top, idx = torch.sort(d2, dim=-1, stable=True)
    dist = torch.sqrt(torch.clamp(top[..., :3], min=0.0))
    return dist, idx[..., :3]


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, m, C), idx (B, n, 3), weight (B, n, 3) -> (B, n, C)."""
    B, n, _ = idx.shape
    C = features.shape[-1]
    gathered = torch.gather(
        features, 1, idx.long().reshape(B, n * 3, 1).expand(-1, -1, C)
    ).reshape(B, n, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)


def interpolate_features(unknown_xyz, known_xyz, known_features):
    """Inverse-distance-weighted 3-NN interpolation (PointnetFPModule)."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    dist_recip = 1.0 / (dist + 1e-8)
    norm = dist_recip.sum(dim=2, keepdim=True)
    return three_interpolate(known_features, idx, dist_recip / norm)
