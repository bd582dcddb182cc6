"""Ball query: fixed-radius neighbourhoods, plain torch.

Counterpart of `rfdnet_tpu/ops/ball_query.py`, with its semantics:
- for each center, the indices of the first (in point-index order)
  <= nsample points with squared distance < radius^2;
- every slot is first padded with the first hit's index;
- a center with no point in radius gets a row of zeros.

The squared distance is the same quadratic form |c|^2 + |p|^2 - 2 c.p as
the JAX package, so points within ~1 ULP of the radius fall on the same
side in both, up to the products' summation order. Centers are processed
in chunks that bound the transient (chunk, N) tensors.
"""

from __future__ import annotations

import torch

# max elements of one chunk's (centers, points) distance matrix
_MAX_CHUNK_ELEMS = 16 * 1024 * 1024


def _ball_query_single(xyz: torch.Tensor, new_xyz: torch.Tensor,
                       radius: float, nsample: int) -> torch.Tensor:
    """xyz (N, 3), new_xyz (M, 3) -> (M, nsample) int64."""
    N, M = xyz.shape[0], new_xyz.shape[0]
    p2 = (xyz * xyz).sum(-1)
    cols = torch.arange(N, device=xyz.device)
    slots = torch.arange(nsample, device=xyz.device)
    chunk = max(1, min(M, _MAX_CHUNK_ELEMS // max(N, 1)))
    out = []
    for c0 in range(0, M, chunk):
        centers = new_xyz[c0:c0 + chunk]
        C = centers.shape[0]
        c2 = (centers * centers).sum(-1)
        d2 = c2[:, None] + p2[None, :] - 2.0 * (centers @ xyz.T)
        mask = d2 < radius * radius
        rank = mask.cumsum(dim=1, dtype=torch.int32)  # 1-based at each hit
        # hit k (k < nsample) goes to slot k; the rest to a dump column
        target = torch.where(mask & (rank <= nsample), rank - 1, nsample)
        idx = torch.zeros((C, nsample + 1), dtype=torch.int64,
                          device=xyz.device)
        idx.scatter_(1, target.long(), cols.expand(C, N))
        idx = idx[:, :nsample]
        count = rank[:, -1:]
        out.append(torch.where(slots[None, :] < count, idx, idx[:, :1]))
    return torch.cat(out, dim=0)


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """xyz (B, N, 3) points, new_xyz (B, M, 3) centers -> (B, M, nsample)
    int64 indices into N (first-hit padded)."""
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    return torch.stack([
        _ball_query_single(xyz[b], new_xyz[b], radius, nsample)
        for b in range(xyz.shape[0])
    ])
