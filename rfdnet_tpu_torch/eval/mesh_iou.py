"""Mesh IoU of the mesh mAP (host numpy and the native voxelizer).

The port's own copy of `rfdnet_tpu/eval/mesh_iou.py`: every mesh is
voxelized at a scene's voxel size (its z-extent / 46) into a surface shell
and an interior fill; the IoU of two meshes is a1 a2 / (a1 + a2 - a1 a2),
where a_i is the share of mesh i's voxel centers (interior, then the
surface cells not interior) that fall in the other mesh's voxels.
`mesh_iou` is a module-level function so that the spawned processes of
`eval_det` can pickle it.
"""

from __future__ import annotations

import numpy as np

from ..meshing.native import fill_interior, voxelize_surface


class VoxelSet:
    """A filled-cell set over a regular grid with world-space lookup."""

    def __init__(self, grid: np.ndarray, origin: np.ndarray, voxel_size: float):
        self.grid = grid.astype(bool)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.voxel_size = float(voxel_size)
        self.filled_count = int(self.grid.sum())

    @property
    def points(self) -> np.ndarray:
        """World-space centers of the filled cells, (n, 3)."""
        idx = np.argwhere(self.grid)
        return self.origin + (idx + 0.5) * self.voxel_size

    def is_filled(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        idx = np.floor((points - self.origin) / self.voxel_size).astype(
            np.int64)
        ok = np.all((idx >= 0) & (idx < np.array(self.grid.shape)), axis=1)
        out = np.zeros(len(points), dtype=bool)
        if ok.any():
            ii = idx[ok]
            out[ok] = self.grid[ii[:, 0], ii[:, 1], ii[:, 2]]
        return out


def voxelize_mesh_pair(vertices, faces, voxel_size: float):
    """(interior, surface) VoxelSets of a mesh over the grid that covers
    its bounding box, max(ceil(extent / voxel_size), 1) + 1 cells an axis,
    from its lowest corner."""
    vertices = np.asarray(vertices, dtype=np.float64)
    if len(vertices) == 0 or len(faces) == 0:
        empty = VoxelSet(np.zeros((1, 1, 1)), np.zeros(3), voxel_size)
        return empty, empty
    mn = vertices.min(0)
    mx = vertices.max(0)
    dims = np.maximum(np.ceil((mx - mn) / voxel_size).astype(int), 1) + 1
    surface = voxelize_surface(vertices, np.asarray(faces, np.int32), mn,
                               voxel_size, tuple(dims))
    interior = fill_interior(surface)
    return VoxelSet(interior, mn, voxel_size), VoxelSet(surface, mn, voxel_size)


def compute_mesh_iou(voxel1, voxel2) -> float:
    """Mutual containment shares of two (interior, surface) pairs,
    combined as a1 a2 / (a1 + a2 - a1 a2); 0 when either is empty."""
    v1_int, v1_surf = voxel1
    v2_int, v2_surf = voxel2
    if v1_surf.filled_count == 0 or v2_surf.filled_count == 0:
        return 0.0

    def own_points(internal, surface):
        if internal.filled_count > 0:
            sp = surface.points
            sp = sp[~internal.is_filled(sp)]
            return np.vstack([internal.points, sp])
        return surface.points

    def contained(points, internal, surface):
        hits = surface.is_filled(points)
        if internal.filled_count > 0:
            hits = hits | internal.is_filled(points)
        return int(hits.sum())

    p1 = own_points(v1_int, v1_surf)
    p2 = own_points(v2_int, v2_surf)
    v1_in_v2 = contained(p1, v2_int, v2_surf)
    v2_in_v1 = contained(p2, v1_int, v1_surf)
    if v1_in_v2 == 0 or v2_in_v1 == 0:
        return 0.0
    a1 = v1_in_v2 / p1.shape[0]
    a2 = v2_in_v1 / p2.shape[0]
    return (a1 * a2) / (a1 + a2 - a1 * a2)


def mesh_iou(mesh1_pair, mesh2_pair) -> float:
    """The `mesh_iou_func` of `eval_det`: each argument an (interior,
    surface) pair of `voxelize_mesh_pair`, or None for a missing mesh."""
    if mesh1_pair is None or mesh2_pair is None:
        return 0.0
    return compute_mesh_iou(mesh1_pair, mesh2_pair)
