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


def center_chunks(n_points: int, n_centers: int) -> int:
    """Centers a chunk when each holds a row of n_points distances."""
    return max(1, min(n_centers, _MAX_CHUNK_ELEMS // max(n_points, 1)))


def in_radius(xyz: torch.Tensor, p2: torch.Tensor, centers: torch.Tensor,
              radius: float) -> torch.Tensor:
    """(C, N) bool: squared distance < radius^2, as the quadratic form
    |c|^2 + |p|^2 - 2 c.p; xyz (N, 3) with p2 = |p|^2 (N,), centers
    (C, 3)."""
    c2 = (centers * centers).sum(-1)
    d2 = c2[:, None] + p2[None, :] - 2.0 * (centers @ xyz.T)
    return d2 < radius * radius


def first_hits(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int):
    """xyz (N, 3), new_xyz (M, 3) -> (idx (M, nsample) int64, count (M,)
    int32): each center's first min(count, nsample) in-radius indices in
    index order in idx's leading slots (zeros after them), and its count
    of points in radius."""
    N, M = xyz.shape[0], new_xyz.shape[0]
    p2 = (xyz * xyz).sum(-1)
    cols = torch.arange(N, device=xyz.device)
    chunk = center_chunks(N, M)
    idxs, counts = [], []
    for c0 in range(0, M, chunk):
        centers = new_xyz[c0:c0 + chunk]
        C = centers.shape[0]
        mask = in_radius(xyz, p2, centers, radius)
        rank = mask.cumsum(dim=1, dtype=torch.int32)  # 1-based at each hit
        # hit k (k < nsample) goes to slot k; the rest to a dump column
        target = torch.where(mask & (rank <= nsample), rank - 1, nsample)
        idx = torch.zeros((C, nsample + 1), dtype=torch.int64,
                          device=xyz.device)
        idx.scatter_(1, target.long(), cols.expand(C, N))
        idxs.append(idx[:, :nsample])
        counts.append(rank[:, -1])
    return torch.cat(idxs, dim=0), torch.cat(counts, dim=0)


def _ball_query_single(xyz: torch.Tensor, new_xyz: torch.Tensor,
                       radius: float, nsample: int) -> torch.Tensor:
    """xyz (N, 3), new_xyz (M, 3) -> (M, nsample) int64."""
    idx, count = first_hits(xyz, new_xyz, radius, nsample)
    slots = torch.arange(nsample, device=xyz.device)
    return torch.where(slots[None, :] < count[:, None], idx, idx[:, :1])


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
