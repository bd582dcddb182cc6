"""Dense bidirectional nearest-neighbour distance, and the huber loss.

Counterpart of `rfdnet_tpu/ops/nn_distance.py` (the vote-loss, center-loss
and objectness-assignment primitive), plain torch: the (B, N, M)
distance block is small on the loss path (at most 1024 x 256).
"""

from __future__ import annotations

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise huber: 0.5 q^2 + delta (|e| - q), q = min(|e|, delta)."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1: bool = False):
    """pc1 (B, N, C), pc2 (B, M, C) -> dist1 (B, N), idx1 (B, N),
    dist2 (B, M), idx2 (B, M): each point's distance to its nearest in the
    other set (squared L2; summed absolute with `l1`) and that point's index, the first on a tie."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    if l1:
        pc_dist = diff.abs().sum(dim=-1)
    else:
        pc_dist = (diff ** 2).sum(dim=-1)
    # amin's gradient splits among tied minima, as jnp.min's; argmin takes
    # the first index of the minimum, as jnp.argmin
    return (pc_dist.amin(dim=2), pc_dist.argmin(dim=2),
            pc_dist.amin(dim=1), pc_dist.argmin(dim=1))
