"""Box dumps as meshes, and the training snapshots.

The port's own copy of `write_ply_rgb`, `write_oriented_bbox_ply` and
`dump_training_snapshot` from `rfdnet_tpu/utils/visualization.py`. The
JAX package renders a voxel grid in 3D with matplotlib, which the machine
with the card need not have; `visualize_voxels` here writes the grid's
three axis projections side by side as a grey PNG (zlib only). The
point-cloud rendering is not ported.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..meshing.mesh import write_ply

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply_rgb(path: str, points: np.ndarray, colors: np.ndarray):
    """A coloured point cloud as a binary PLY: points (N, 3), colors (N, 3)
    as uint8, or as floats in [0, 1] (clipped, then scaled to 0-255)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        ).encode())
        rec = np.empty((len(points),),
                       dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
        rec["xyz"] = points
        rec["rgb"] = colors
        f.write(rec.tobytes())


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


def write_png(path: str, image: np.ndarray) -> None:
    """An (H, W) uint8 image as an 8-bit grey PNG, or an (H, W, 3) one as an
    8-bit RGB PNG."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    color_type = 2 if image.ndim == 3 else 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\0" + image[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                                                0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def visualize_voxels(voxels: np.ndarray, out_file: str, cell: int = 8):
    """A voxel grid (X, Y, Z) as three projections (along x, y, z; the
    depth of the first occupied voxel in grey, white where none is), side
    by side, each voxel `cell` pixels wide, written to `out_file`."""
    occ = np.asarray(voxels) > 0.5
    views = []
    for axis in range(3):
        depth = occ.argmax(axis=axis).astype(np.float64)
        hit = occ.any(axis=axis)
        n = occ.shape[axis]
        grey = np.where(hit, 40 + 160 * depth / max(n - 1, 1), 255)
        views.append(np.kron(grey, np.ones((cell, cell))))
    gap = np.full((views[0].shape[0], cell), 255.0)
    write_png(out_file, np.concatenate(
        [views[0], gap, views[1], gap, views[2]], axis=1).astype(np.uint8))


def dump_training_snapshot(vis_path: str, epoch: int, phase: str, it: int,
                           voxels_out: np.ndarray, proposal_ids: np.ndarray,
                           gt_voxels: np.ndarray, n_shapes_per_batch: int,
                           rng=None, n_samples: int = 3):
    """Up to `n_samples` random predicted 16^3 shapes (voxels_out
    (B * P, 16, 16, 16)) with their GT objects' voxels (gt_voxels
    (B, MAX_NUM_OBJ, 16, 16, 16), picked through proposal_ids (B, P, 3)),
    as `<epoch>_<phase>_<it>_<k>_pred.png` and `..._gt_cls<class>.png`."""
    os.makedirs(vis_path, exist_ok=True)
    rng = rng or np.random
    total = voxels_out.shape[0]
    ids = (rng.choice(total, n_samples, replace=False)
           if total >= n_samples else range(total))
    for idx, i in enumerate(ids):
        stem = os.path.join(vis_path, f"{epoch}_{phase}_{it}_{idx:03d}")
        visualize_voxels(voxels_out[i], f"{stem}_pred.png")
        b, k = i // n_shapes_per_batch, i % n_shapes_per_batch
        box_id, cls_id = int(proposal_ids[b, k, 1]), int(proposal_ids[b, k, 2])
        visualize_voxels(gt_voxels[b, box_id], f"{stem}_gt_cls{cls_id}.png")
