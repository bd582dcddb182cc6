"""Box dumps as meshes.

The port's own copy of `write_oriented_bbox_ply` from
`rfdnet_tpu/utils/visualization.py`; the training snapshots and the
renderings of that module are not ported.
"""

from __future__ import annotations

import numpy as np

from ..meshing.mesh import write_ply

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_oriented_bbox_ply(path: str, corners_list: np.ndarray,
                            radius: float = 0.01):
    """Boxes (K, 8, 3) as thin triangulated edge tubes of square
    cross-section."""
    corners_list = np.asarray(corners_list).reshape(-1, 8, 3)
    verts, faces = [], []
    for corners in corners_list:
        for a, b in _BOX_EDGES:
            v0, v1 = corners[a], corners[b]
            d = v1 - v0
            n = np.linalg.norm(d)
            if n < 1e-9:
                continue
            d = d / n
            # orthonormal frame around the edge
            up = np.array([0.0, 0.0, 1.0])
            if abs(d @ up) > 0.9:
                up = np.array([1.0, 0.0, 0.0])
            s = np.cross(d, up)
            s /= np.linalg.norm(s)
            t = np.cross(d, s)
            base = len(verts)
            for end in (v0, v1):
                for sa, sb in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
                    verts.append(end + radius * (sa * s + sb * t))
            for k in range(4):
                k2 = (k + 1) % 4
                faces.append([base + k, base + 4 + k, base + 4 + k2])
                faces.append([base + k, base + 4 + k2, base + k2])
    if not verts:
        verts = np.zeros((0, 3))
        faces = np.zeros((0, 3), np.int32)
    write_ply(path, np.asarray(verts), np.asarray(faces, np.int32))
