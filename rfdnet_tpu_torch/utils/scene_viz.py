"""A renderable scene (points, instance meshes, oriented boxes) and its box
helpers, numpy only.

The port's own copy of the parts of `rfdnet_tpu/utils/scene_viz.py` that
the dumps use: `hls_palette`, the box conversions, `SceneRender` with its
WebGL (`export_html`, `scene_html.py`) and colored-PLY (`export_ply`)
exports. The JAX package's matplotlib renders are not copied: the port's
`pred.png` comes from its own numpy renderer (`utils/render.py`).

All geometry is in the scene/depth frame (z up). A box is a center and 3
half-edge vectors (the `bbox.pkl` convention), or 7 parameters [center,
size, heading] through `box7_to_vectors`.
"""

from __future__ import annotations

import colorsys

import numpy as np

__all__ = [
    "hls_palette",
    "box7_to_vectors",
    "corners_to_center_vectors",
    "place_canonical_mesh_in_box7",
    "SceneRender",
]


def corners_to_center_vectors(corners: np.ndarray):
    """(8, 3) box corners (corners 1, 3, 4 adjacent to corner 0) ->
    (center, 3 half-edge vectors)."""
    corners = np.asarray(corners, np.float64)
    center = corners.mean(axis=0)
    vectors = np.stack([
        (corners[1] - corners[0]) / 2.0,
        (corners[3] - corners[0]) / 2.0,
        (corners[4] - corners[0]) / 2.0,
    ])
    return center, vectors


def hls_palette(n: int, h: float = 0.01, l: float = 0.6, s: float = 0.65):
    """n colors of evenly spaced hue (seaborn's `hls` defaults), (n, 3) in
    [0, 1]."""
    hues = (np.linspace(0.0, 1.0, n, endpoint=False) + h) % 1.0
    return np.array([colorsys.hls_to_rgb(hh, l, s) for hh in hues])


def box7_to_vectors(box7: np.ndarray):
    """Depth-frame box [cx, cy, cz, sx, sy, sz, heading] -> (center, 3
    half-edge vectors): the columns of the heading's rotation scaled by the
    half sizes."""
    center = np.asarray(box7[:3], np.float64)
    half = np.asarray(box7[3:6], np.float64) / 2.0
    a = float(box7[6])
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    vectors = (R * half[None, :]).T  # row i = half-edge vector i
    return center, vectors


def place_canonical_mesh_in_box7(vertices: np.ndarray, box7: np.ndarray):
    """Vertices of a canonical [-0.5, 0.5]^3 mesh placed in a depth-frame
    box: scaled by its size, rotated by its heading, moved to its center."""
    center, vectors = box7_to_vectors(np.asarray(box7, np.float64))
    return np.asarray(vertices, np.float64) @ (2.0 * vectors) + center


_BOX_FACES = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5),
              (2, 3, 7, 6), (3, 0, 4, 7)]


def _corners(center, vectors):
    """The 8 corners of a box: bottom ring 0-1-2-3, corner k + 4 above k."""
    c = np.asarray(center, np.float64)
    v0, v1, v2 = np.asarray(vectors, np.float64)
    return np.array([
        c - v0 - v1 - v2, c + v0 - v1 - v2, c + v0 + v1 - v2,
        c - v0 + v1 - v2, c - v0 - v1 + v2, c + v0 - v1 + v2,
        c + v0 + v1 + v2, c - v0 + v1 + v2,
    ])


class SceneRender:
    """One renderable scene: points + instance meshes + oriented boxes.

    scene_points: (N, >=3) scan points.
    meshes: list of (vertices (V, 3), faces (F, 3)) in the scene frame.
    centers / vectors: per-instance box center (3,) and half-edge
        vectors (3, 3).
    class_ids: per-instance index into the 8-class palette.
    """

    def __init__(self, scene_points, meshes=(), centers=(), vectors=(),
                 class_ids=(), num_classes: int = 8):
        self.scene_points = np.asarray(scene_points, np.float64)[:, :3]
        self.meshes = [
            (np.asarray(v, np.float64), np.asarray(f, np.int64))
            for v, f in meshes
        ]
        self.centers = [np.asarray(c, np.float64) for c in centers]
        self.vectors = [np.asarray(v, np.float64) for v in vectors]
        self.class_ids = [int(c) for c in class_ids]
        self.palette_cls = hls_palette(num_classes)
        self.palette_inst = hls_palette(10)

    def _inst_color(self, i):
        return self.palette_inst[i % len(self.palette_inst)]

    def _cls_color(self, i):
        return self.palette_cls[self.class_ids[i] % len(self.palette_cls)]

    def export_ply(self, path: str, color_mode: str = "class",
                   max_points: int = 100000):
        """The scene in one colored binary PLY: the points grey, each mesh
        in its class (or instance) color."""
        pts = self.scene_points
        step = max(1, len(pts) // max_points)
        sub = pts[::step]
        verts = [sub]
        vcols = [np.full((len(sub), 3), 160, np.uint8)]
        faces = []
        off = len(sub)
        for i, (v, f) in enumerate(self.meshes):
            if len(v) == 0:
                continue
            color = (self._cls_color(i) if color_mode == "class"
                     else self._inst_color(i))
            verts.append(v)
            vcols.append(np.tile((np.asarray(color) * 255).astype(np.uint8),
                                 (len(v), 1)))
            faces.append(np.asarray(f, np.int64) + off)
            off += len(v)
        allv = np.vstack(verts)
        allc = np.vstack(vcols)
        allf = (np.vstack(faces) if faces
                else np.zeros((0, 3), np.int64))
        with open(path, "wb") as fh:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(allv)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
                f"element face {len(allf)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            )
            fh.write(header.encode("ascii"))
            rec = np.zeros(len(allv), dtype=[("xyz", "<f4", 3),
                                             ("rgb", "u1", 3)])
            rec["xyz"] = allv
            rec["rgb"] = allc
            fh.write(rec.tobytes())
            frec = np.zeros(len(allf), dtype=[("n", "u1"),
                                              ("idx", "<i4", 3)])
            frec["n"] = 3
            frec["idx"] = allf
            fh.write(frec.tobytes())
        return path

    def export_html(self, path: str, title: str = "scene",
                    class_names=(), color_mode: str = "class",
                    max_points: int = 120000):
        """The interactive WebGL file of the scene (`scene_html.py`)."""
        from .scene_html import export_scene_html

        return export_scene_html(
            self, path, title=title, class_names=class_names,
            color_mode=color_mode, max_points=max_points,
        )
