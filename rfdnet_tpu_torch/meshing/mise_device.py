"""MISE on the device: every proposal's octree refined with tensor ops on
the card, one host sync a level.

Counterpart of `rfdnet_tpu/meshing/mise_device.py`
(`make_mise_device_global`, `_active_voxels`, `_offsets`,
`reconstruct_dense`). Where the JAX program works in static shapes (a
budget of voxels a level, overflow detection, re-dispatch at doubled
budgets), PyTorch takes data-dependent shapes: each level takes exactly
its active voxels (`torch.nonzero`, ascending (proposal, voxel) order)
and decodes exactly their unknown child points, at the cost of one host
sync a level.

- Level 0 decodes the (res0+1)^3 corner lattice of every proposal; the
  slots that are not valid are set to -1e4 (everywhere outside), so they
  refine nothing.
- Level l (voxel side s = 2^(steps-l) lattice units, n = res0 * 2^l voxels
  an axis) activates the voxels whose 8 corners are known and of mixed
  sign (value >= logit(threshold)), marks the 27 points of each one's
  half-stride lattice, and decodes the marked points not known yet:
  grouped by proposal into (proposals with points, T_l), T_l padded to a
  multiple of the CBN kernel's 64-point tile (the kernel tiles 64 points
  of one proposal, and the decoder is pointwise given the proposal's
  tables, so the grouping changes no value).
- The output is sparse: the level-0 lattice, and per level the refined
  voxels' ids with the 27 values of each one's child lattice. Marching
  cubes runs from it on the host (`native.mise_marching_cubes_batch`),
  so no (R+1)^3 grid crosses PCIe; `reconstruct_dense` rebuilds the dense
  grid (for checks).

The dense values and known flags of one scene's octree live on the
device during `mise_device` only: 64 x 129^3 x 5 bytes = 0.69 GB at
res0 32, two steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mise import decode_chunked, lattice_to_points

#: the most points (proposals x points) one decode takes (a memory bound:
#: 4 GiB of fc_p output)
MAX_POINTS = 1 << 22
INVALID_LOGIT = -1e4


def offsets(s: int, device=None) -> torch.Tensor:
    """The 27-point child lattice offsets (a-major, (0, h, s)^3) of a voxel
    of side s, (27, 3) int64."""
    h = s // 2
    ax = (0, h, s)
    return torch.tensor([[a, b, c] for a in ax for b in ax for c in ax],
                        dtype=torch.int64, device=device)


def active_voxels(values, known, n: int, s: int, logit_thresh: float):
    """Mixed-sign, fully known voxels at stride s of (Nb, R+1, R+1, R+1)
    values and known flags -> (Nb, n, n, n) bool."""
    v = values[:, ::s, ::s, ::s]
    kn = known[:, ::s, ::s, ::s]
    occ = (v >= logit_thresh).to(torch.int32)
    kn = kn.to(torch.int32)
    c = torch.zeros(v.shape[0], n, n, n, dtype=torch.int32, device=v.device)
    k8 = torch.zeros_like(c)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c += occ[:, dx:n + dx, dy:n + dy, dz:n + dz]
                k8 += kn[:, dx:n + dx, dy:n + dy, dz:n + dz]
    return (c > 0) & (c < 8) & (k8 == 8)


@dataclasses.dataclass
class MiseOutput:
    """The sparse result of one scene's octree, on the device.

    lvl0 (Nb, n0+1, n0+1, n0+1) f32 logits; idx (M,) int32 refined-voxel
    ids (level l: over the (res0 * 2^l)^3 voxel grid) and vals (M, 27)
    f32, both in (proposal, level, voxel) order; level_counts (Nb, steps)
    int32. `levels` holds, for level 0 (the lattice) and each refinement
    level, the host counts: `active` voxels (None at level 0), decoded
    `points`, `padded` points decoded (with the tile padding), `proposals`
    decoded, `launches` of the decoder."""

    lvl0: torch.Tensor
    idx: torch.Tensor
    vals: torch.Tensor
    level_counts: torch.Tensor
    levels: list


def mise_device(decode, nb: int, resolution_0: int, upsampling_steps: int,
                threshold: float, padding: float, valid=None, device=None,
                max_points: int = MAX_POINTS) -> MiseOutput:
    """Run one scene's octrees on `device`. decode: (points (k, T, 3),
    rows (k,) int64 or None for all) -> logits (k, T), a decoder bound to
    the scene's nb proposals (`Generator3D.bind`). valid: (nb,) bool or
    None (all valid)."""
    res0, steps = int(resolution_0), int(upsampling_steps)
    R = res0 << steps
    logit_thresh = float(np.log(threshold) - np.log(1.0 - threshold))
    dev = torch.device(device) if device is not None else torch.device("cpu")
    chunk = lambda k: max(64, (max_points // max(k, 1)) // 64 * 64)

    n0 = res0 + 1
    ax = torch.arange(0, R + 1, 1 << steps, device=dev)
    lattice0 = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                           dim=-1).reshape(-1, 3)
    p0 = lattice_to_points(lattice0, R, padding)
    ct = chunk(nb)
    v0 = decode_chunked(decode, p0[None].expand(nb, -1, -1), ct)
    if valid is not None:
        v0 = torch.where(torch.as_tensor(valid, device=dev).reshape(nb, 1),
                         v0, torch.full_like(v0, INVALID_LOGIT))
    lvl0 = v0.reshape(nb, n0, n0, n0)
    levels = [dict(active=None, points=nb * n0 ** 3, proposals=nb,
                   padded=nb * _padded(n0 ** 3, ct),
                   launches=-(-n0 ** 3 // ct))]
    parts = []  # per level: (proposal, level, voxel id, 27 values)
    if steps:
        values = torch.zeros((nb, R + 1, R + 1, R + 1), dtype=torch.float32,
                             device=dev)
        known = torch.zeros((nb, R + 1, R + 1, R + 1), dtype=torch.bool,
                            device=dev)
        values[:, ::1 << steps, ::1 << steps, ::1 << steps] = lvl0
        known[:, ::1 << steps, ::1 << steps, ::1 << steps] = True
    for l in range(steps):
        s = 1 << (steps - l)
        n = res0 << l
        vox = torch.nonzero(active_voxels(values, known, n, s, logit_thresh))
        K = vox.shape[0]  # (K, 4): proposal, i, j, k, ascending
        pts = vox[:, None, 1:] * s + offsets(s, dev)[None]  # (K, 27, 3)
        prop = vox[:, :1].expand(K, 27)
        need = torch.zeros_like(known)
        need[prop, pts[..., 0], pts[..., 1], pts[..., 2]] = True
        need &= ~known
        q = torch.nonzero(need)  # (P, 4): proposal, x, y, z, ascending
        counts = torch.bincount(q[:, 0], minlength=nb)
        rows = torch.nonzero(counts).reshape(-1)
        k, T = len(rows), int(counts.max()) if len(q) else 0  # host sync
        ct = chunk(k)
        levels.append(dict(active=K, points=q.shape[0], proposals=k,
                           padded=k * _padded(T, ct),
                           launches=-(-T // ct)))
        if not K:
            continue
        if T:
            # (proposal, point) -> (row of the decode, rank in its row)
            row_of = torch.full((nb,), -1, dtype=torch.int64, device=dev)
            row_of[rows] = torch.arange(k, device=dev)
            rank = (torch.arange(q.shape[0], device=dev)
                    - (torch.cumsum(counts, 0) - counts)[q[:, 0]])
            r = row_of[q[:, 0]]
            grid = torch.zeros((k, T, 3), dtype=torch.float32, device=dev)
            grid[r, rank] = lattice_to_points(q[:, 1:], R, padding)
            out = decode_chunked(decode, grid, ct, rows)
            values[q[:, 0], q[:, 1], q[:, 2], q[:, 3]] = out[r, rank]
            known[q[:, 0], q[:, 1], q[:, 2], q[:, 3]] = True
        parts.append((vox[:, 0], torch.full((K,), l, device=dev),
                      (vox[:, 1] * n + vox[:, 2]) * n + vox[:, 3],
                      values[prop, pts[..., 0], pts[..., 1], pts[..., 2]]))
    if parts:
        prop, lev, idx, vals = (torch.cat(x) for x in zip(*parts))
        key = prop * steps + lev
        # (proposal, level, voxel): each level is in voxel order already
        order = torch.sort(key, stable=True).indices
        idx, vals = idx[order].to(torch.int32), vals[order]
        level_counts = torch.bincount(key, minlength=nb * steps)
    else:
        idx = torch.zeros(0, dtype=torch.int32, device=dev)
        vals = torch.zeros((0, 27), dtype=torch.float32, device=dev)
        level_counts = torch.zeros(nb * steps, dtype=torch.int64, device=dev)
    return MiseOutput(lvl0=lvl0, idx=idx, vals=vals,
                      level_counts=level_counts.reshape(nb, steps).to(
                          torch.int32), levels=levels)


def _padded(t: int, chunk_t: int) -> int:
    """Points a row decodes for t points in chunks of chunk_t, each padded
    to a multiple of 64."""
    return sum(-(-min(chunk_t, t - k) // 64) * 64 for k in range(0, t, chunk_t))


def reconstruct_dense(lvl0, idx, vals, level_counts, resolution_0: int,
                      upsampling_steps: int) -> torch.Tensor:
    """The dense (Nb, R+1, R+1, R+1) logit grids of a `MiseOutput`'s
    fields (tensors on any one device): the level values scattered, then
    every unknown point filled from its coarsest known ancestor corner,
    level by level (`MISE.to_dense`)."""
    res0, steps = int(resolution_0), int(upsampling_steps)
    R = res0 << steps
    nb = lvl0.shape[0]
    dev = lvl0.device
    values = torch.zeros((nb, R + 1, R + 1, R + 1), dtype=torch.float32,
                         device=dev)
    known = torch.zeros_like(values, dtype=torch.bool)
    s0 = 1 << steps
    values[:, ::s0, ::s0, ::s0] = lvl0.float()
    known[:, ::s0, ::s0, ::s0] = True
    counts = level_counts.to(torch.int64).reshape(nb, steps)
    flat_counts = counts.reshape(-1)
    prop = torch.repeat_interleave(
        torch.arange(nb, device=dev).repeat_interleave(steps), flat_counts)
    lev = torch.repeat_interleave(
        torch.arange(steps, device=dev).repeat(nb), flat_counts)
    idx = idx.to(torch.int64)
    for l in range(steps):
        sel = lev == l
        s = 1 << (steps - l)
        n = res0 << l
        i = idx[sel]
        base = torch.stack([i // (n * n), (i // n) % n, i % n], -1) * s
        pts = base[:, None, :] + offsets(s, dev)[None]
        p = prop[sel][:, None].expand(-1, 27)
        values[p, pts[..., 0], pts[..., 1], pts[..., 2]] = vals[sel].float()
        known[p, pts[..., 0], pts[..., 1], pts[..., 2]] = True
    for l in range(steps):
        s = 1 << (steps - l)
        h = s // 2
        src = (torch.arange(0, R + 1, h, device=dev) // s) * s
        coarse = values[:, src[:, None, None], src[None, :, None],
                        src[None, None, :]]
        sub = values[:, ::h, ::h, ::h]
        kn = known[:, ::h, ::h, ::h]
        values[:, ::h, ::h, ::h] = torch.where(kn, sub, coarse)
        known[:, ::h, ::h, ::h] = True
    return values
