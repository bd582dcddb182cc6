"""Chamfer distance: blocked nearest-neighbour search, differentiable
distances.

Counterpart of `rfdnet_tpu/ops/chamfer.py` (computed there in XLA, not a
TPU kernel), in plain torch. The nearest index is searched without
gradient, with the squared distance in the quadratic form
|a|^2 + |b|^2 - 2 a.b (float32 products, TF32 off) and ties to the first
index; the distance is then recomputed from the gathered point, so the
gradient flows through the matched pair only. The search runs in blocks
of query rows, so no (B, N, M) distance tensor is held whole:
`max_block_elems` bounds one block's distances.
"""

from __future__ import annotations

import torch

# 2^26 float32 distances: 256 MiB a block
MAX_BLOCK_ELEMS = 1 << 26


@torch.no_grad()
def nearest_neighbour(queries: torch.Tensor, candidates: torch.Tensor,
                      max_block_elems: int = MAX_BLOCK_ELEMS) -> torch.Tensor:
    """queries (B, N, 3), candidates (B, M, 3) -> (B, N) int64: the index
    of each query's nearest candidate, the first one on a tie."""
    B, N, _ = queries.shape
    M = candidates.shape[1]
    q2 = torch.sum(queries * queries, dim=-1)
    c2 = torch.sum(candidates * candidates, dim=-1)
    ct = candidates.transpose(1, 2)
    rows = max(1, max_block_elems // max(B * M, 1))
    out = torch.empty((B, N), dtype=torch.int64, device=queries.device)
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        d2 = q2[:, r0:r1, None] + c2[:, None, :]
        # (|q|^2 + |c|^2) - 2 q.c, the product's -2 exact in the epilogue
        d2.baddbmm_(queries[:, r0:r1], ct, beta=1.0, alpha=-2.0)
        out[:, r0:r1] = torch.argmin(d2, dim=-1)
    return out


def squared_distance_to_nearest(queries: torch.Tensor,
                                candidates: torch.Tensor) -> torch.Tensor:
    """(B, N): each query's squared distance to its nearest candidate,
    differentiable in both sets through the matched pair."""
    idx = nearest_neighbour(queries.detach(), candidates.detach())
    matched = torch.gather(candidates, 1,
                           idx[..., None].expand(-1, -1, candidates.shape[2]))
    return torch.sum((queries - matched) ** 2, dim=-1)


def chamfer_distance(set1: torch.Tensor, set2: torch.Tensor):
    """Bidirectional squared-L2 chamfer distances. set1 (B, N, 3), set2
    (B, M, 3) -> (dist1 (B, N): each set1 point's squared distance to its
    nearest set2 point, dist2 (B, M): the reverse)."""
    set1, set2 = set1.float(), set2.float()
    return (squared_distance_to_nearest(set1, set2),
            squared_distance_to_nearest(set2, set1))
