"""A numpy renderer of a demo scene: the port's `pred.png`.

The JAX package draws `pred.png` with matplotlib (`rfdnet_tpu/demo.py`
`visualize`), which the machine with the card does not have. This renders
the same content in numpy and writes it with the zlib PNG writer of
`utils/visualization.py`:
- the scan thinned to at most 20000 points, grey by height, as 2 x 2
  pixel dots at opacity 0.75 (a marker's face and edge, each at 0.5);
- each valid slot's box edges and its placed mesh (at most ~2000 faces,
  60 % opaque), in the slot's tab20 color;
- matplotlib's 3D view of that figure: elevation 55, azimuth -60, the
  perspective camera at distance 10 with focal length 1, the box aspect
  from the scan's extent, data limits from everything drawn widened by
  55/48 about their middle, and the axes where a 10 x 8 in figure at 120
  dpi with a tight layout puts them (1200 x 960 pixels).

Triangles are filled by sampling each one at about two points a pixel;
where several cover a pixel the nearest wins. Lines are 2 pixels wide.
"""

from __future__ import annotations

import numpy as np

from .visualization import write_png

WIDTH, HEIGHT = 1200, 960
TAB20 = np.array([
    (0.121569, 0.466667, 0.705882), (0.682353, 0.780392, 0.909804),
    (1.0, 0.498039, 0.054902), (1.0, 0.733333, 0.470588),
    (0.172549, 0.627451, 0.172549), (0.596078, 0.87451, 0.541176),
    (0.839216, 0.152941, 0.156863), (1.0, 0.596078, 0.588235),
    (0.580392, 0.403922, 0.741176), (0.772549, 0.690196, 0.835294),
    (0.54902, 0.337255, 0.294118), (0.768627, 0.611765, 0.580392),
    (0.890196, 0.466667, 0.760784), (0.968627, 0.713725, 0.823529),
    (0.498039, 0.498039, 0.498039), (0.780392, 0.780392, 0.780392),
    (0.737255, 0.741176, 0.133333), (0.858824, 0.858824, 0.552941),
    (0.090196, 0.745098, 0.811765), (0.619608, 0.854902, 0.898039),
])
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7))
# the axes of the figure in pixels (left, bottom, side) and their 2D view
# limits: matplotlib's tight layout of one 3D axes in a 10 x 8 in figure
_AXES_PX = (138.0, 18.0, 924.0)
_VIEW_LIM = (-0.095, 0.09)
# matplotlib's box-aspect scale and camera
_ASPECT_SCALE = 1.8294640721620434 * 25 / 24
_DIST, _LIMIT_WIDEN = 10.0, 55 / 48


class Camera:
    """matplotlib's perspective projection of a 3D axes (see the module
    docstring) for data limits `lims` ((3, 2)) and box aspect `aspect`."""

    def __init__(self, lims, aspect, elev=55.0, azim=-60.0):
        lims = np.asarray(lims, np.float64)
        aspect = np.asarray(aspect, np.float64)
        aspect = aspect * _ASPECT_SCALE / np.linalg.norm(aspect)
        self.lo = lims[:, 0]
        self.scale = aspect / (lims[:, 1] - lims[:, 0])
        e, a = np.deg2rad(elev), np.deg2rad(azim)
        ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                       np.sin(e)])
        center = 0.5 * aspect
        self.eye = center + _DIST * ps
        w = (self.eye - center) / np.linalg.norm(self.eye - center)
        u = np.cross([0.0, 0.0, 1.0], w)
        u /= np.linalg.norm(u)
        self.uvw = np.stack([u, np.cross(w, u), w])

    def __call__(self, points):
        """points (..., 3) -> pixel columns, pixel rows (from the top) and
        distances along the view, each (...)."""
        world = (np.asarray(points, np.float64) - self.lo) * self.scale
        view = (world - self.eye) @ self.uvw.T
        depth = -view[..., 2]
        x, y = view[..., 0] / depth, view[..., 1] / depth
        left, bottom, side = _AXES_PX
        px_per = side / (_VIEW_LIM[1] - _VIEW_LIM[0])
        col = left + (x - _VIEW_LIM[0]) * px_per
        row = HEIGHT - (bottom + (y - _VIEW_LIM[0]) * px_per)
        return col, row, depth


def _pixels(col, row):
    """Flat pixel indices of the samples inside the image, and their mask."""
    c, r = np.floor(col).astype(np.int64), np.floor(row).astype(np.int64)
    inside = (c >= 0) & (c < WIDTH) & (r >= 0) & (r < HEIGHT)
    return r[inside] * WIDTH + c[inside], inside


def _triangle_samples(tri_px, rng):
    """Barycentric samples of projected triangles (T, 3, 3: column, row,
    depth): about two a pixel of area, at least the 3 corners and the
    centroid. Returns (samples (S, 3), triangle index (S,))."""
    a, b, c = tri_px[:, 0], tri_px[:, 1], tri_px[:, 2]
    area = 0.5 * np.abs((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                        - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1]))
    n = np.minimum(np.ceil(2.0 * area).astype(np.int64), 20000)
    owner = np.repeat(np.arange(len(tri_px)), n)
    w = rng.random((len(owner), 2))
    flip = w.sum(1) > 1.0
    w[flip] = 1.0 - w[flip]
    bary = np.concatenate([w, 1.0 - w.sum(1, keepdims=True)], 1)
    fixed = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                              [1 / 3, 1 / 3, 1 / 3]]), (len(tri_px), 1))
    bary = np.concatenate([bary, fixed])
    owner = np.concatenate([owner, np.repeat(np.arange(len(tri_px)), 4)])
    return np.einsum("sk,skd->sd", bary, tri_px[owner]), owner


def render_scene(points, boxes=(), meshes=(), colors=()):
    """An RGB image (HEIGHT, WIDTH, 3) uint8 of the scan `points` (N, >=3),
    box corners `boxes` (each (8, 3)), meshes (each (verts (V, 3), faces
    (F, 3))) and one RGB color in [0, 1] per box and mesh, in the scene
    frame."""
    pc = np.asarray(points, np.float64)[:, :3]
    sub = pc[::max(1, len(pc) // 20000)]
    tris = [np.asarray(v, np.float64)[np.asarray(f)[::max(1, len(f) // 2000)]]
            for v, f in meshes]
    drawn = [sub] + [np.asarray(b, np.float64) for b in boxes] + [
        t.reshape(-1, 3) for t in tris]
    allp = np.concatenate(drawn)
    lo, hi = allp.min(0), allp.max(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * _LIMIT_WIDEN
    cam = Camera(np.stack([mid - half, mid + half], 1),
                 pc.max(0) - pc.min(0))
    image = np.ones((HEIGHT * WIDTH, 3))

    # the scan: grey by height
    col, row, _ = cam(sub)
    z = sub[:, 2]
    t = (z - z.min()) / (z.max() - z.min()) if z.max() > z.min() else (
        np.zeros_like(z))
    for dc, dr in ((0, 0), (1, 0), (0, 1), (1, 1)):
        pix, inside = _pixels(col + dc, row + dr)
        image[pix] = 0.75 * t[inside, None] + 0.25 * image[pix]

    # the meshes: the nearest triangle sample of each pixel, alpha 0.6
    tri_px, tri_color = [], []
    for tri, color in zip(tris, colors):
        if len(tri):
            c, r, d = cam(tri)
            tri_px.append(np.stack([c, r, d], -1))
            tri_color.append(np.broadcast_to(color, (len(tri), 3)))
    if tri_px:
        tri_px = np.concatenate(tri_px)
        tri_color = np.concatenate(tri_color)
        samples, owner = _triangle_samples(tri_px, np.random.default_rng(0))
        pix, inside = _pixels(samples[:, 0], samples[:, 1])
        depth, owner = samples[inside, 2], owner[inside]
        order = np.lexsort((depth, pix))
        first = np.unique(pix[order], return_index=True)[1]
        near = order[first]
        image[pix[near]] = (0.6 * tri_color[owner[near]]
                            + 0.4 * image[pix[near]])

    # the box edges, opaque, 2 pixels wide
    for corners, color in zip(boxes, colors):
        for a, b in BOX_EDGES:
            seg = np.asarray(corners, np.float64)[[a, b]]
            c, r, _ = cam(seg)
            n = int(np.ceil(2 * np.hypot(c[1] - c[0], r[1] - r[0]))) + 2
            s = np.linspace(0.0, 1.0, n)
            cc, rr = c[0] + s * (c[1] - c[0]), r[0] + s * (r[1] - r[0])
            for dc, dr in ((0, 0), (1, 0), (0, 1)):
                pix, _ = _pixels(cc + dc, rr + dr)
                image[pix] = color
    return (np.clip(image, 0.0, 1.0) * 255 + 0.5).astype(np.uint8).reshape(
        HEIGHT, WIDTH, 3)


def write_scene_png(path: str, points, boxes=(), meshes=(), colors=()):
    """`render_scene` written as an RGB PNG at `path`."""
    write_png(path, render_scene(points, boxes, meshes, colors))
    return path
