"""Placement of generated meshes in the scene.

Counterpart of `rfdnet_tpu/eval/tester.py`, of which only
`place_mesh_in_box` is ported; the `Tester` class (GT fields, AP) is not
yet (ROADMAP.md, 'The Tester with GT fields').
"""

from __future__ import annotations

import numpy as np

from .refit import TRANSFORM_SHAPENET, _box_params_from_corners


def place_mesh_in_box(mesh, box_corners_cam: np.ndarray):
    """Place a canonical ([-0.55, 0.55]^3-ish) mesh into a camera-frame
    corner box, in the depth/scan frame. Returns a copy."""
    params = _box_params_from_corners(np.asarray(box_corners_cam))
    centroid, sizes, orientation = params[:3], params[3:6], params[6]
    out = mesh.copy()
    v = np.asarray(out.vertices)
    if len(v) == 0:
        return out
    v = v - (v.max(0) + v.min(0)) / 2.0
    v = v @ TRANSFORM_SHAPENET.T
    extent = v.max(0) - v.min(0)
    v = v / np.where(extent > 0, extent, 1.0) * sizes
    cs, sn = np.cos(orientation), np.sin(orientation)
    R = np.array([[cs, sn, 0], [-sn, cs, 0], [0, 0, 1]])
    out.vertices = v @ R + centroid
    return out
