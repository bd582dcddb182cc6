"""MISE on the host: multi-resolution iso-surface extraction with an octree
per proposal, the decodes on the device of the features.

The port's own copy of `rfdnet_tpu/meshing/mise.py`. `MISE` is the Python
oracle of one proposal's octree over a (R+1)^3 corner lattice,
R = resolution_0 * 2^depth: `query()` yields the unknown lattice points
of the current level, the caller decodes them, `update()` stores the
values and activates the child voxels whose corners span the threshold,
and `to_dense()` fills the final dense grid (an unknown point takes the
value of its coarsest known ancestor corner, which keeps the signs
marching cubes reads, since a voxel left unrefined has corners of one
sign).

`mise_value_grids` runs every proposal's octree (the C++ `MiseNative`) in
lock-step, one padded decode per round: each proposal's frontier padded
to a common length, a multiple of the CBN kernel's 64-point tile, decoded
in chunks of at most 32768 points. The device octree
(`meshing/mise_device.py`) does the same on the card without the host
round trips.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cbn_decoder import TILE_T

#: the most points a proposal decodes in one call (a memory bound)
CHUNK_T = 32768


class MISE:
    """Single-object octree refinement over a (R+1)^3 corner lattice,
    R = resolution_0 * 2^depth. Lattice coordinates are ints in [0, R]."""

    def __init__(self, resolution_0: int, depth: int, threshold: float):
        self.res0 = int(resolution_0)
        self.depth = int(depth)
        self.threshold = float(threshold)
        self.R = self.res0 * 2 ** self.depth
        self.values = np.full((self.R + 1,) * 3, np.nan, dtype=np.float64)
        self.level = 0
        ax = np.arange(0, self.R + 1, 2 ** self.depth)
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        self._pending = np.stack(
            [gx.ravel(), gy.ravel(), gz.ravel()], axis=-1).astype(np.int64)

    def query(self) -> np.ndarray:
        """(n, 3) int lattice points whose value is still unknown."""
        if len(self._pending) == 0:
            return self._pending
        p = self._pending
        known = ~np.isnan(self.values[p[:, 0], p[:, 1], p[:, 2]])
        return p[~known]

    def update(self, points: np.ndarray, values: np.ndarray) -> None:
        points = np.asarray(points, dtype=np.int64).reshape(-1, 3)
        self.values[points[:, 0], points[:, 1], points[:, 2]] = values
        self._advance()

    def _advance(self) -> None:
        """Find the active voxels of the current level and queue their
        child corner points; stop at full resolution."""
        if self.level >= self.depth:
            self._pending = np.zeros((0, 3), dtype=np.int64)
            return
        s = 2 ** (self.depth - self.level)  # voxel edge in lattice units
        n = self.R // s  # voxels per axis at this level
        v = self.values[::s, ::s, ::s]
        occ = v >= self.threshold
        known = ~np.isnan(v)
        # a voxel is active if its 8 corners are known (its parents were
        # refined down to this level) and their signs are mixed
        c = np.zeros((n, n, n), dtype=np.int32)
        k = np.zeros((n, n, n), dtype=np.int32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    c += occ[dx:n + dx, dy:n + dy, dz:n + dz]
                    k += known[dx:n + dx, dy:n + dy, dz:n + dz]
        active = (c > 0) & (c < 8) & (k == 8)
        ii, jj, kk = np.nonzero(active)
        h = s // 2
        if len(ii):
            # the 27-point (3x3x3) half-stride lattice of each active voxel
            offs = np.array([[a, b, cc] for a in (0, h, s) for b in (0, h, s)
                             for cc in (0, h, s)], dtype=np.int64)
            base = np.stack([ii, jj, kk], axis=-1) * s
            pts = (base[:, None, :] + offs[None, :, :]).reshape(-1, 3)
            pts = np.unique(pts, axis=0)
            known = ~np.isnan(self.values[pts[:, 0], pts[:, 1], pts[:, 2]])
            self._pending = pts[~known]
        else:
            self._pending = np.zeros((0, 3), dtype=np.int64)
        self.level += 1
        if len(self._pending) == 0 and self.level < self.depth:
            self._advance()

    def done(self) -> bool:
        return len(self.query()) == 0

    def to_dense(self) -> np.ndarray:
        """(R+1)^3 dense value grid; an unknown point takes its coarsest
        known ancestor corner's value (floor-aligned at each level)."""
        out = self.values.copy()
        for lvl in range(self.depth):
            s = 2 ** (self.depth - lvl)
            h = s // 2
            src = (np.arange(self.R + 1) // s) * s
            sub = out[::h, ::h, ::h]  # a view: assignments land in `out`
            coarse = out[np.ix_(src[::h], src[::h], src[::h])]
            mask = np.isnan(sub)
            sub[mask] = coarse[mask]
        return out


def _make_tree(resolution_0: int, depth: int, threshold: float):
    """The C++ octree; raises if the library does not build."""
    from .native import MiseNative

    return MiseNative(resolution_0, depth, threshold)


def lattice_to_points(q, R: int, padding: float):
    """Lattice coordinates (..., 3) ints in [0, R] -> points of the padded
    unit box, float32 (numpy for numpy, torch for torch)."""
    box_size = 1.0 + padding
    if isinstance(q, torch.Tensor):
        return box_size * (q.float() / R - 0.5)
    return box_size * (np.asarray(q).astype(np.float32) / R - 0.5)


def decode_chunked(decode, points: torch.Tensor, chunk_t: int = CHUNK_T,
                   rows=None) -> torch.Tensor:
    """decode(points (k, t, 3), rows) over T in chunks of at most chunk_t
    points, each padded to a multiple of TILE_T. Returns (k, T)."""
    T = points.shape[1]
    outs = []
    for k in range(0, T, chunk_t):
        p = points[:, k:k + chunk_t]
        t = p.shape[1]
        tp = -(-t // TILE_T) * TILE_T
        if tp != t:
            p = torch.nn.functional.pad(p, (0, 0, 0, tp - t))
        outs.append(decode(p, rows)[:, :t])
    return torch.cat(outs, dim=1) if len(outs) != 1 else outs[0]


def mise_value_grids(decode, nb: int, resolution_0: int,
                     upsampling_steps: int, threshold: float, padding: float,
                     device=None, chunk_t: int = CHUNK_T) -> np.ndarray:
    """Every proposal's octree in lock-step on the host, the decodes on
    `device`. decode: (points (nb, T, 3), rows) -> logits (nb, T) (a bound
    decoder, `Generator3D.bind`). Returns (nb, R+1, R+1, R+1) float32
    logit grids (`to_dense`)."""
    logit_thresh = float(np.log(threshold) - np.log(1.0 - threshold))
    trees = [_make_tree(resolution_0, upsampling_steps, logit_thresh)
             for _ in range(nb)]
    R = trees[0].R
    while True:
        queries = [t.query() for t in trees]
        maxc = max(len(q) for q in queries)
        if maxc == 0:
            break
        pts = np.zeros((nb, maxc, 3), dtype=np.float32)
        for i, q in enumerate(queries):
            if len(q):
                pts[i, :len(q)] = lattice_to_points(q, R, padding)
        logits = decode_chunked(
            decode, torch.from_numpy(pts).to(device), chunk_t).cpu().numpy()
        for i, q in enumerate(queries):
            if len(q):
                trees[i].update(q, logits[i, :len(q)])
    return np.stack([t.to_dense() for t in trees]).astype(np.float32)
