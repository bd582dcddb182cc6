"""Spatially sorted point sharding with a halo exchange.

Counterpart of `rfdnet_tpu/parallel/halo.py`. `point_shard.py`'s ball
query all-gathers every rank's candidate hits, O(nsample x world) a
center; this layout makes neighbour traffic O(halo):

1. `slab_sort` orders each scene's points by x once; equal-count
   contiguous blocks of the sorted array are the ranks' slabs, so the
   load is balanced and a slab is spatially coherent.
2. `required_halo` (host, numpy) checks the geometric contract for a
   radius (every interior slab wider than the radius, so a ball never
   reaches past the next slab) and returns the halo width H: the most
   points within the radius of a slab boundary, on either side.
3. `ball_query_halo`: each rank sends its first and last H points to its
   neighbours (`_neighbor_halos`, point-to-point) and resolves each of
   its centers against its slab and the two strips alone. The result
   equals `ops.ball_query` on the unsorted cloud: the candidates hold
   every in-radius point by the contract, each pair's distance is the
   same quadratic form, and ranking by ORIGINAL index gives the first
   <= nsample in index order, first-hit padded.
4. `fps_bucketed`: each rank samples its slab to k npoint / world
   candidates with `ops.furthest_point_sample` (the FPS kernel on the
   card, `skip_near_origin` passed through), one all-gather moves the
   candidates, and FPS over them picks the final npoint. When the
   candidates cover the slab it equals exact FPS index for index.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.ball_query import center_chunks, in_radius
from ..ops.fps import furthest_point_sample
from ..collectives import DataGroup
from .mesh import all_gather_rows

_BIG = 2 ** 30


def slab_sort(xyz: torch.Tensor):
    """Sort each scene's points by x (stably). Returns (xyz_sorted,
    orig_ids), orig_ids (B, N) int64: sorted row -> original index."""
    order = torch.argsort(xyz[..., 0], dim=1, stable=True)
    return torch.gather(xyz, 1, order[..., None].expand_as(xyz)), order


def required_halo(xyz_sorted: np.ndarray, radius: float, n_dev: int) -> int:
    """Host-side check of the halo contract for this batch of sorted
    scenes: every interior slab's x extent exceeds `radius` (a ball
    centered in slab k cannot reach past slabs k +- 1). Returns H, the
    most points within `radius` of a slab boundary on either side: the
    strip width `ball_query_halo` exchanges."""
    xs = np.asarray(xyz_sorted)[..., 0]
    B, N = xs.shape
    n_loc = N // n_dev
    H = 1
    for b in range(B):
        for k in range(1, n_dev):
            bound = 0.5 * (xs[b, k * n_loc - 1] + xs[b, k * n_loc])
            left = int((xs[b, : k * n_loc] > bound - radius).sum())
            right = int((xs[b, k * n_loc:] < bound + radius).sum())
            H = max(H, left, right)
        for k in range(1, n_dev - 1):  # interior slab widths
            width = xs[b, (k + 1) * n_loc - 1] - xs[b, k * n_loc]
            if not width > radius:
                raise ValueError(
                    f"slab {k} of scene {b} is {width:.4f} wide < radius "
                    f"{radius}: in-radius points can span beyond adjacent "
                    f"slabs; use fewer ranks or the all-gather ball query")
    if H > n_loc:
        raise ValueError(f"halo {H} exceeds slab size {n_loc}")
    return H


def _neighbor_halos(block: torch.Tensor, group: DataGroup, H: int):
    """(from_left, from_right): the last H rows (axis 1) of the left
    neighbour's block and the first H of the right one's; zeros at the
    edges (callers mask them). Every rank posts its sends and receives in
    one order (right, left) in one batch, so NCCL cannot deadlock."""
    r, world = group.rank, group.world
    from_left = torch.zeros_like(block[:, :H])
    from_right = torch.zeros_like(block[:, :H])
    to_right = block[:, -H:].contiguous()
    to_left = block[:, :H].contiguous()
    ops = []
    if r + 1 < world:
        ops += [dist.P2POp(dist.isend, to_right, r + 1, group.group),
                dist.P2POp(dist.irecv, from_right, r + 1, group.group)]
    if r > 0:
        ops += [dist.P2POp(dist.isend, to_left, r - 1, group.group),
                dist.P2POp(dist.irecv, from_left, r - 1, group.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


@torch.no_grad()
def ball_query_halo(xyz_local: torch.Tensor, ids_local: torch.Tensor,
                    center_idx: torch.Tensor, radius: float, nsample: int,
                    H: int, group: DataGroup) -> torch.Tensor:
    """Halo-local distributed ball query. xyz_local (B, n_loc, 3): this
    rank's slab of the `slab_sort`ed cloud, ids_local (B, n_loc) its
    original indices, center_idx (B, M) the query centers' global SORTED
    indices (replicated), H from `required_halo` -> (B, M, nsample) int64
    ORIGINAL indices, equal to `ops.ball_query(xyz, centers)` on the
    unsorted cloud."""
    n_loc = xyz_local.shape[1]
    base, r, world = group.rank * n_loc, group.rank, group.world
    x = xyz_local.float()
    ids = ids_local.long()
    hl, hr = _neighbor_halos(x, group, H)
    il, ir = _neighbor_halos(ids, group, H)
    cand = torch.cat([hl, x, hr], dim=1)  # (B, n_loc + 2H, 3)
    cand_ids = torch.cat([il, ids, ir], dim=1)
    ok = torch.ones(n_loc + 2 * H, dtype=torch.bool, device=x.device)
    ok[:H], ok[H + n_loc:] = r > 0, r < world - 1  # edge strips hold nothing
    # my centers: global sorted index in [base, base + n_loc)
    loc = center_idx.long() - base
    own = (loc >= 0) & (loc < n_loc)
    c = torch.gather(x, 1, loc.clamp(0, n_loc - 1)[..., None].expand(
        -1, -1, 3))
    B, M = center_idx.shape
    n_cand = cand.shape[1]
    if n_cand < nsample:
        raise ValueError(f"{n_cand} candidates for {nsample} samples")
    slot = torch.arange(nsample, device=x.device)
    chunk = center_chunks(n_cand, M)
    out = torch.zeros((B, M, nsample), dtype=torch.int64, device=x.device)
    for b in range(B):
        p2 = (cand[b] * cand[b]).sum(-1)
        for c0 in range(0, M, chunk):
            rows = slice(c0, c0 + chunk)
            # `ops.ball_query`'s quadratic form, for every candidate
            mask = in_radius(cand[b], p2, c[b, rows], radius) & ok
            keyed = torch.where(mask, cand_ids[b], _BIG)
            # first <= nsample by ORIGINAL index: the smallest original ids
            top = torch.topk(keyed, nsample, dim=-1, largest=False).values
            n_hit = mask.sum(dim=-1).clamp(max=nsample)[:, None]
            top = torch.where(slot < n_hit, top, top[:, :1])
            out[b, rows] = torch.where((n_hit > 0) & own[b, rows, None],
                                       top, 0)
    dist.all_reduce(out, group=group.group)
    return out


def local_budget(npoint: int, world: int, k: int, n_loc: int) -> int:
    """`fps_bucketed`'s candidates a slab: min(max(k npoint / world,
    npoint / world + 1), n_loc)."""
    return min(max(k * npoint // world, npoint // world + 1), n_loc)


@torch.no_grad()
def fps_bucketed(xyz_local: torch.Tensor, npoint: int, group: DataGroup,
                 k: int = 4, skip_near_origin: bool = True) -> torch.Tensor:
    """Two-level distributed FPS over slab-sorted points. xyz_local
    (B, n_loc, 3) this rank's slab -> (B, npoint) int64 global SORTED
    indices. Each rank samples its slab to `local_budget` candidates,
    one all-gather of the candidates, FPS over them: with local_m = n_loc,
    exact FPS of the
    sorted cloud; below that the bucketed approximation (FlashFPS /
    FuseFPS)."""
    B, n_loc, _ = xyz_local.shape
    world = group.world
    base = group.rank * n_loc
    local_m = local_budget(npoint, world, k, n_loc)
    x = xyz_local.float().contiguous()
    li = furthest_point_sample(x, local_m,
                               skip_near_origin=skip_near_origin).long()
    cand = torch.gather(x, 1, li[..., None].expand(-1, -1, 3))
    all_cand = all_gather_rows(cand[None], group)  # (world, B, lm, 3)
    all_gids = all_gather_rows((li + base)[None], group)
    cat = all_cand.transpose(0, 1).reshape(B, world * local_m, 3)
    gid = all_gids.transpose(0, 1).reshape(B, world * local_m)
    sel = furthest_point_sample(cat.contiguous(), npoint,
                                skip_near_origin=skip_near_origin)
    return torch.gather(gid, 1, sel.long())
