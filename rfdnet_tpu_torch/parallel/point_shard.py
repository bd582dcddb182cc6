"""Point-sharded SA1: the point axis of the first set abstraction split
into equal contiguous blocks over the ranks of a group.

Counterpart of `rfdnet_tpu/parallel/point_shard.py`, whose `shard_map`
bodies become per-rank code with `torch.distributed` collectives. Each
rank holds block r of every scene, points [r n_loc, (r + 1) n_loc) of
N = world x n_loc, and the three point-cloud primitives become
collective algorithms that return exactly what the one-process ops
return on the whole cloud:

- `fps_sharded`: exact distributed furthest point sampling. Each rank
  keeps the running min-distance of its block; per step an all-reduce
  MAX of the best distance, an all-reduce MIN of the global index that
  attains it (`_BIG` elsewhere: ties go to the lowest global index), and
  a masked SUM that hands every rank the winner's coordinates. The
  distance is `ops.fps.fps_plain`'s arithmetic, so the selections equal
  the FPS kernel's and the plain version's. Its steps are plain torch
  (the JAX one is XLA, not Pallas): npoint - 1 dependent steps of three
  collectives each, latency-bound.
- `ball_query_sharded`: each rank finds its block's first <= nsample
  in-radius points in index order with `ops.ball_query.first_hits` (the
  same quadratic form), then one `all_gather` of hits and counts and the
  order-preserving merge rebuild the global "first nsample in index
  order, first-hit padded, zeros without a hit" result.
- `gather_points_sharded` / `group_points_sharded`: the owner of each
  index gathers, the others give exact zeros, one SUM all-reduce.

`sa1_forward_sharded` composes them into the SA1 forward of the port's
`SetAbstraction` (max pooling). The centers and the shared MLP are
replicated: only the O(N) distance and selection work is sharded.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.common import max_pool_points
from ..ops.ball_query import first_hits
from ..collectives import DataGroup
from .mesh import all_gather_rows

_BIG = 2 ** 30


def _all_reduce(x: torch.Tensor, group: DataGroup, op=dist.ReduceOp.SUM):
    dist.all_reduce(x, op=op, group=group.group)
    return x


def _block(xyz_local: torch.Tensor, group: DataGroup):
    """(n_loc, base): the block's length and its first global index."""
    n_loc = xyz_local.shape[1]
    return n_loc, group.rank * n_loc


# --------------------------------------------------------------------- FPS
@torch.no_grad()
def fps_sharded(xyz_local: torch.Tensor, npoint: int, group: DataGroup,
                skip_near_origin: bool = True) -> torch.Tensor:
    """Exact distributed FPS. xyz_local (B, n_loc, 3): this rank's block
    -> (B, npoint) int32 global indices, the same on every rank and equal
    to `ops.furthest_point_sample` on the whole (B, N, 3) cloud."""
    B = xyz_local.shape[0]
    n_loc, base = _block(xyz_local, group)
    xyz = xyz_local.float()
    x, y, z = xyz.unbind(-1)
    cand = ((x * x + y * y + z * z) > 1e-3 if skip_near_origin
            else torch.ones_like(x, dtype=torch.bool))
    rows = torch.arange(B, device=xyz.device)

    def owner_coords(g):
        """The coordinates of global index g (B,), from its owner."""
        loc = g - base
        own = (loc >= 0) & (loc < n_loc)
        c = xyz[rows, loc.clamp(0, n_loc - 1)]
        return _all_reduce(torch.where(own[:, None], c, 0.0), group)

    mind = torch.full((B, n_loc), 1e10, dtype=torch.float32,
                      device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = owner_coords(out[:, 0])
    for i in range(1, npoint):
        dx = x - last[:, 0:1]
        dy = y - last[:, 1:2]
        dz = z - last[:, 2:3]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        eff = torch.where(cand, mind, -1.0)
        il = eff.argmax(dim=1)  # the first local maximum
        mx_l = eff[rows, il]
        mx_g = _all_reduce(mx_l.clone(), group, dist.ReduceOp.MAX)
        gl = torch.where(mx_l >= mx_g, base + il, _BIG)
        g = _all_reduce(gl, group, dist.ReduceOp.MIN)
        out[:, i] = g
        last = owner_coords(g)
    return out.to(torch.int32)


# -------------------------------------------------------------- ball query
@torch.no_grad()
def ball_query_sharded(xyz_local: torch.Tensor, new_xyz: torch.Tensor,
                       radius: float, nsample: int,
                       group: DataGroup) -> torch.Tensor:
    """Distributed ball query with `ops.ball_query`'s semantics. xyz_local
    (B, n_loc, 3) this rank's block, new_xyz (B, M, 3) replicated ->
    (B, M, nsample) int64 global indices."""
    n_loc, base = _block(xyz_local, group)
    B, M = new_xyz.shape[:2]
    found = [first_hits(xyz_local[b].float(), new_xyz[b].float(), radius,
                        nsample) for b in range(B)]
    hits = torch.stack([h for h, _ in found]) + base  # (B, M, ns)
    count = torch.stack([c for _, c in found]).clamp(max=nsample).long()
    # every rank's hits and counts: (world, B, M, ns), (world, B, M)
    all_hits = all_gather_rows(hits[None], group)
    all_cnt = all_gather_rows(count[None], group)
    offs = torch.cumsum(all_cnt, dim=0) - all_cnt  # exclusive
    slot = torch.arange(nsample, device=hits.device)
    out = torch.full((B, M, nsample), _BIG, dtype=torch.int64,
                     device=hits.device)
    for k in range(group.world):
        # rank k's hit j lands in slot offs[k] + j: slot s reads s - offs[k]
        src = slot - offs[k][..., None]
        valid = (src >= 0) & (src < all_cnt[k][..., None])
        got = torch.gather(all_hits[k], -1, src.clamp(0, nsample - 1))
        out = torch.where(valid, got, out)
    total = all_cnt.sum(dim=0).clamp(max=nsample)
    out = torch.where(slot < total[..., None], out, out[..., :1])
    return torch.where(total[..., None] > 0, out, 0)


# ----------------------------------------------------------------- gathers
@torch.no_grad()
def gather_points_sharded(features_local: torch.Tensor, idx: torch.Tensor,
                          group: DataGroup) -> torch.Tensor:
    """features_local (B, n_loc, C) this rank's block, idx (B, M) global
    -> (B, M, C), exact: the owner gathers, the others add zeros."""
    n_loc, base = _block(features_local, group)
    loc = idx.long() - base
    own = (loc >= 0) & (loc < n_loc)
    C = features_local.shape[-1]
    vals = torch.gather(features_local, 1, loc.clamp(0, n_loc - 1)[
        ..., None].expand(-1, -1, C))
    return _all_reduce(torch.where(own[..., None], vals, 0).contiguous(),
                       group)


def group_points_sharded(features_local: torch.Tensor, idx: torch.Tensor,
                         group: DataGroup) -> torch.Tensor:
    """features_local (B, n_loc, C), idx (B, M, S) global ->
    (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points_sharded(features_local, idx.reshape(B, M * S),
                                 group).reshape(B, M, S, -1)


# -------------------------------------------------------------- full SA1
def sa1_forward_sharded(sa_module, xyz_local: torch.Tensor,
                        features_local: torch.Tensor | None,
                        group: DataGroup):
    """The SA1 forward of a max-pooling `models.pointnet2.SetAbstraction`
    with the point axis sharded: (new_xyz (B, npoint, 3), new_features
    (B, npoint, mlp[-1]), inds (B, npoint)), equal to
    `sa_module(xyz, features)` on the whole cloud. The grouped
    neighbourhoods are assembled by owner-computes sums and the shared MLP
    runs on them on every rank (in the module's own mode)."""
    inds = fps_sharded(xyz_local, sa_module.npoint, group)
    new_xyz = gather_points_sharded(xyz_local, inds, group)
    idx = ball_query_sharded(xyz_local, new_xyz, sa_module.radius,
                             sa_module.nsample, group)
    grouped = group_points_sharded(xyz_local, idx, group) - new_xyz[
        :, :, None, :]
    if sa_module.normalize_xyz:
        grouped = grouped / sa_module.radius
    if features_local is not None:
        feats = group_points_sharded(features_local, idx, group)
        grouped = (torch.cat([grouped, feats], dim=-1) if sa_module.use_xyz
                   else feats)
    new_features = max_pool_points(sa_module.mlp(grouped), dim=2).float()
    return new_xyz, new_features, inds
