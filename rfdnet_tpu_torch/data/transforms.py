"""Point-set sampling transforms (host-side numpy).

The port's own copy of `rfdnet_tpu/data/transforms.py`: occupancy
supervision sets drawn as [N_out, N_in] points split by occupancy (test
mode takes the first rows, so evaluation draws no random numbers), scene
subsampling and the z rotation.
"""

from __future__ import annotations

import numpy as np


def random_sampling(pc: np.ndarray, num_sample: int, rng=None,
                    return_choices: bool = False):
    """Subsample (or pad by resampling) pc (N, C) to num_sample rows."""
    rng = rng or np.random
    N = pc.shape[0]
    replace = N < num_sample
    choices = rng.choice(N, num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def subsample_points(points: np.ndarray, occ: np.ndarray, n, mode: str,
                     rng=None):
    """Subsample an occupancy supervision set.

    n: int -> uniform subsample; [n_out, n_in] -> split by occupancy >= 0.5,
    sample each side with replacement (train) or take the first rows
    (test). Returns (points, occ[, volume]) with occ rewritten to exact
    0/1 in the split mode.
    """
    rng = rng or np.random
    if isinstance(n, int):
        if mode == "test":
            idx = np.arange(0, n)
        else:
            idx = rng.randint(points.shape[0], size=n)
        return points[idx], occ[idx]

    n_out, n_in = n
    binary = occ >= 0.5
    out_pool = np.flatnonzero(~binary)
    in_pool = np.flatnonzero(binary)
    if mode == "test":
        idx0 = np.arange(0, n_out)
        idx1 = np.arange(0, n_in)
    else:
        idx0 = rng.randint(max(out_pool.shape[0], 1), size=n_out) % max(
            out_pool.shape[0], 1)
        idx1 = rng.randint(max(in_pool.shape[0], 1), size=n_in) % max(
            in_pool.shape[0], 1)
    p_out = (points[out_pool[idx0]] if out_pool.shape[0]
             else np.zeros((n_out, 3), dtype=points.dtype))
    p_in = (points[in_pool[idx1]] if in_pool.shape[0]
            else np.zeros((n_in, 3), dtype=points.dtype))
    pts = np.concatenate([p_out, p_in], axis=0)
    occ_out = np.concatenate(
        [np.zeros(n_out, np.float32), np.ones(n_in, np.float32)])
    volume = np.float32(binary.sum() / max(len(binary), 1))
    return pts, occ_out, volume


def rotz(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
