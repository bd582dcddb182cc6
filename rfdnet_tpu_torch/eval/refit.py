"""Box parameters in the scan frame.

Counterpart of `rfdnet_tpu/eval/refit.py`, of which only the pieces the
demo dump needs are ported: the ShapeNet-to-scan axis swap and the
7-parameter box of a corner box. The mesh-to-scan Adam refit (the demo's
`post_processing`) is not ported yet (ROADMAP.md, 'Refit').
"""

from __future__ import annotations

import numpy as np

from .box_util import flip_axis_to_depth

TRANSFORM_SHAPENET = np.array([[0, 0, -1], [-1, 0, 0], [0, 1, 0]], np.float64)


def _box_params_from_corners(box_corners_cam: np.ndarray) -> np.ndarray:
    """corners (8, 3) camera frame -> [centroid(3), sizes(3), orientation]
    in the depth frame."""
    c = flip_axis_to_depth(box_corners_cam)
    centroid = (c.max(0) + c.min(0)) / 2.0
    forward = c[1] - c[2]
    left = c[0] - c[1]
    up = c[6] - c[2]
    orientation = np.arctan2(forward[1], forward[0])
    sizes = np.linalg.norm(np.stack([forward, left, up]), axis=1)
    return np.concatenate([centroid, sizes, [orientation]])
