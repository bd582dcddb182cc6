"""Depth rendering and TSDF fusion of the offline preparation.

Counterpart of `render_depth` and `tsdf_fuse` of
`rfdnet_tpu/meshing/native.py`, which run on the host
(`rfdnet_tpu/meshing/src/prep.cpp`). Here a CUDA tensor launches a
hand-written kernel (`csrc/render_depth.cu`, `csrc/tsdf_fuse.cu`) and a
CPU tensor takes the plain torch version of the same arithmetic
(`render_depth_plain`, `tsdf_fuse_plain`, float64), which `chip_smoke.py`
also runs on the card to hold each kernel to it. Kernel and plain version
do every double operation separately rounded, in the same order, and so
agree bit for bit.

Conventions (the JAX package's): a pose is a row-major 4x4 world->camera
matrix with +z looking forward; the pinhole projects (x, y, z) to
(f x / z + cx, f y / z + cy); a depth map is (H, W) float32 with 0 where
nothing is seen; the TSDF grid is (res, res, res) float32 in units of
`trunc`, + in front of the surface, +1 where no view sees a voxel.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import _native

_F64 = torch.float64
# (triangle, pixel) pairs the plain raster evaluates at once, and voxels
# the plain fusion carries at once: bounds of its temporaries' memory
PLAIN_PAIRS = 1 << 20
PLAIN_VOXELS = 1 << 18


def _poses(poses: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(n, 4, 4) poses and whether one (4, 4) pose was given."""
    single = poses.dim() == 2
    if poses.shape[-2:] != (4, 4) or poses.dim() not in (2, 3):
        raise ValueError(f"poses shape {tuple(poses.shape)}: expected (4, 4) "
                         "or (n, 4, 4)")
    return (poses[None] if single else poses), single


def _project_triangles(verts, tris, poses, f, cx, cy, width, height):
    """Per (view, triangle), flattened view-major: the projected corners
    (ax, ay, bx, by, gx, gy), the inverse camera depths (iza, izb, izc),
    the screen determinant, the clipped pixel box (x0, y0, nx, ny) and
    whether the triangle is drawn (every z > 1e-6, |det| >= 1e-12, a
    non-empty box). The operations of `csrc/render_depth.cu`."""
    verts = verts.to(_F64)
    n = poses.shape[0]
    x, y, z = (verts[:, c][None] for c in range(3))
    m = poses.to(_F64)
    cam = [((m[:, r, 0:1] * x + m[:, r, 1:2] * y) + m[:, r, 2:3] * z)
           + m[:, r, 3:4] for r in range(3)]  # each (n, V)
    corners = []
    for c in range(3):
        idx = tris[:, c].long()
        corners.append(tuple(t[:, idx] for t in cam))  # each (n, T)
    drawn = torch.ones_like(corners[0][0], dtype=torch.bool)
    for _, _, zc in corners:
        drawn &= zc > 1e-6
    proj, inv_z = [], []
    for xc, yc, zc in corners:
        zs = torch.where(drawn, zc, 1.0)
        proj += [(f * xc) / zs + cx, (f * yc) / zs + cy]
        inv_z.append(1.0 / zs)
    ax, ay, bx, by, gx, gy = (torch.where(drawn, p, 0.0) for p in proj)
    x0 = torch.floor(torch.minimum(torch.minimum(ax, bx), gx)).long()
    x1 = torch.ceil(torch.maximum(torch.maximum(ax, bx), gx)).long()
    y0 = torch.floor(torch.minimum(torch.minimum(ay, by), gy)).long()
    y1 = torch.ceil(torch.maximum(torch.maximum(ay, by), gy)).long()
    x0, y0 = x0.clamp(min=0), y0.clamp(min=0)
    nx = (x1.clamp(max=width - 1) - x0 + 1).clamp(min=0)
    ny = (y1.clamp(max=height - 1) - y0 + 1).clamp(min=0)
    det = (bx - ax) * (gy - ay) - (gx - ax) * (by - ay)
    drawn &= (det.abs() >= 1e-12) & (nx > 0) & (ny > 0)
    flat = dict(ax=ax, ay=ay, bx=bx, by=by, gx=gx, gy=gy, iza=inv_z[0],
                izb=inv_z[1], izc=inv_z[2], det=det, x0=x0, y0=y0, nx=nx,
                ny=ny, drawn=drawn)
    out = {k: v.reshape(-1) for k, v in flat.items()}
    out["view"] = torch.arange(n, device=verts.device).repeat_interleave(
        tris.shape[0])
    return out


def render_depth_plain(verts, tris, poses, f: float, cx: float, cy: float,
                       width: int, height: int, work=None) -> torch.Tensor:
    """The plain torch version of the raster kernel, on any device: each
    drawn triangle's (triangle, pixel) pairs of its box, vectorised,
    reduced into the depth buffer with a `scatter_reduce` amin. Returns
    (n, H, W) float32, or (H, W) for one (4, 4) pose. A `work` dict gets
    the counts of this input's work: (view, triangle) pairs, those drawn,
    the pixels of their boxes and the pixels they cover."""
    poses, single = _poses(poses)
    n = poses.shape[0]
    dev = verts.device
    tri = _project_triangles(verts, tris.to(dev), poses.to(dev), float(f),
                            float(cx), float(cy), width, height)
    keep = tri["drawn"].nonzero().squeeze(1)
    items = len(tri["drawn"])
    tri = {k: v[keep] for k, v in tri.items()}
    counts = tri["nx"] * tri["ny"]
    covered = 0
    depth = torch.full((n * height * width,), float("inf"),
                       dtype=torch.float32, device=dev)
    ends = torch.cumsum(counts, 0)
    lo = 0
    while lo < len(counts):
        # the next run of triangles holding at most PLAIN_PAIRS pairs
        # (a single larger triangle goes alone)
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + PLAIN_PAIRS,
                                                right=True)))
        covered += _raster_pairs({k: v[lo:hi] for k, v in tri.items()},
                                 counts[lo:hi], depth, width, height)
        lo = hi
    if work is not None:
        work.update(items=items, drawn=len(counts),
                    box_pixels=int(counts.sum()), covered=covered)
    depth = torch.where(torch.isinf(depth), 0.0, depth)
    depth = depth.reshape(n, height, width)
    return depth[0] if single else depth


def _raster_pairs(tri: dict, counts, depth, width: int, height: int) -> int:
    """Rasterise one run of triangles into `depth`; returns the number of
    covered (triangle, pixel) pairs."""
    dev = depth.device
    rep = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  counts)
    starts = torch.cumsum(counts, 0) - counts
    off = torch.arange(len(rep), device=dev) - starts[rep]
    nx = tri["nx"][rep]
    xi = tri["x0"][rep] + off % nx
    yi = tri["y0"][rep] + off // nx
    px, py = xi.to(_F64) + 0.5, yi.to(_F64) + 0.5
    ax, ay, bx, by, gx, gy, det = (tri[k][rep] for k in (
        "ax", "ay", "bx", "by", "gx", "gy", "det"))
    w1 = ((px - ax) * (gy - ay) - (gx - ax) * (py - ay)) / det
    w2 = ((bx - ax) * (py - ay) - (px - ax) * (by - ay)) / det
    w0 = (1.0 - w1) - w2
    cover = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    iz = (w0 * tri["iza"][rep] + w1 * tri["izb"][rep]) + w2 * tri["izc"][rep]
    z = (1.0 / iz).to(torch.float32)
    pix = (tri["view"][rep] * height + yi) * width + xi
    depth.scatter_reduce_(0, pix[cover], z[cover], "amin")
    return int(cover.sum())


def tsdf_fuse_plain(depths, poses, f: float, cx: float, cy: float, res: int,
                    bbox, trunc: float, work=None) -> torch.Tensor:
    """The plain torch version of the fusion kernel, on any device: voxels
    in chunks of PLAIN_VOXELS, each chunk through the views in order.
    Returns (res, res, res) float32. A `work` dict gets the counts of this
    input's work: voxel-views, those in front of the camera, those that
    read a depth > 0 in the image, and those averaged."""
    poses, _ = _poses(poses)
    n, H, W = depths.shape
    dev = depths.device
    lo, hi = [float(b) for b in bbox[:3]], [float(b) for b in bbox[3:6]]
    step = [(hi[a] - lo[a]) / res for a in range(3)]
    pose_rows = poses.to(_F64).cpu().reshape(n, 16).tolist()
    f, cx, cy, trunc = float(f), float(cx), float(cy), float(trunc)
    flat_depths = depths.reshape(n, H * W)
    total = res ** 3
    out = torch.empty(total, dtype=torch.float32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    for start in range(0, total, PLAIN_VOXELS):
        lin = torch.arange(start, min(start + PLAIN_VOXELS, total),
                           device=dev)
        ijk = (lin // (res * res), (lin // res) % res, lin % res)
        p0, p1, p2 = ((ijk[a].to(_F64) + 0.5) * step[a] + lo[a]
                      for a in range(3))
        acc = torch.zeros(len(lin), dtype=_F64, device=dev)
        wsum = torch.zeros_like(acc)
        for v, m in enumerate(pose_rows):
            czp = ((m[8] * p0 + m[9] * p1) + m[10] * p2) + m[11]
            seen = czp > 1e-6
            counts[0] += seen.sum()
            zs = torch.where(seen, czp, 1.0)
            cxp = ((m[0] * p0 + m[1] * p1) + m[2] * p2) + m[3]
            cyp = ((m[4] * p0 + m[5] * p1) + m[6] * p2) + m[7]
            u = ((f * cxp) / zs + cx).to(torch.int64)  # toward zero
            w = ((f * cyp) / zs + cy).to(torch.int64)
            seen &= (u >= 0) & (u < W) & (w >= 0) & (w < H)
            d = flat_depths[v][torch.where(seen, w * W + u, 0)].to(_F64)
            seen &= d > 0
            counts[1] += seen.sum()
            sdf = (d - czp) / trunc
            seen &= sdf >= -1.0
            counts[2] += seen.sum()
            acc += torch.where(seen, torch.clamp(sdf, max=1.0), 0.0)
            wsum += seen.to(_F64)
        out[lin] = torch.where(wsum > 0, acc / wsum, 1.0).to(torch.float32)
    if work is not None:
        in_front, sampled, averaged = counts.tolist()
        work.update(voxel_views=total * n, in_front=in_front,
                    sampled=sampled, averaged=averaged)
    return out.reshape(res, res, res)


def _render_cuda(verts, tris, poses, f, cx, cy, width, height):
    dev = verts.device
    _native.check_tensor(verts, "verts", _F64, (None, 3), dev)
    _native.check_tensor(tris, "tris", torch.int32, (None, 3), dev)
    _native.check_tensor(poses, "poses", _F64, (None, 4, 4), dev)
    if len(tris) and (int(tris.min()) < 0 or int(tris.max()) >= len(verts)):
        raise ValueError("tris index outside verts")
    if poses.shape[0] < 1 or width < 1 or height < 1:
        raise ValueError(f"render_depth: {poses.shape[0]} views of "
                         f"{width} x {height}")
    out = torch.empty((poses.shape[0], height, width), dtype=torch.float32,
                      device=dev)
    fn = _native.load("render_depth").rfd_render_depth_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_double] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(_native.ptr(verts), _native.ptr(tris), len(tris),
                 _native.ptr(poses), poses.shape[0], float(f), float(cx),
                 float(cy), width, height, _native.ptr(out),
                 _native.stream(dev))
    _native.check_launch(err, "render_depth")
    count("ops.render_depth.launches")
    return out


def render_depth(verts, tris, poses, f: float, cx: float, cy: float,
                 width: int, height: int) -> torch.Tensor:
    """Pinhole z-buffer depth maps of a mesh: verts (V, 3) float64, tris
    (T, 3) int32, poses (n, 4, 4) float64 world->camera -> (n, H, W)
    float32, 0 where nothing is seen; one (4, 4) pose gives (H, W), the
    JAX package's one-view call.

    CUDA tensors go to the kernel (every view in one launch; contiguous
    tensors of these types required), CPU tensors to the plain version.
    The counter `ops.render_depth.launches` counts the kernel's
    launches."""
    poses, single = _poses(poses)
    if verts.device.type == "cpu":
        out = render_depth_plain(verts, tris, poses, f, cx, cy, width,
                                 height)
    else:
        out = _render_cuda(verts, tris, poses, f, cx, cy, width, height)
    return out[0] if single else out



def _fuse_cuda(depths, poses, f, cx, cy, res, bbox, trunc):
    dev = depths.device
    n, H, W = depths.shape
    _native.check_tensor(depths, "depths", torch.float32, (n, H, W), dev)
    _native.check_tensor(poses, "poses", _F64, (n, 4, 4), dev)
    if not 1 <= res <= 2048:
        raise ValueError(f"tsdf_fuse: res {res}")
    box = [float(b) for b in bbox]
    if len(box) != 6:
        raise ValueError(f"tsdf_fuse: bbox has {len(box)} values, expected 6")
    out = torch.empty((res, res, res), dtype=torch.float32, device=dev)
    fn = _native.load("tsdf_fuse").rfd_tsdf_fuse_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_double] * 3 + [ctypes.c_int]
                   + [ctypes.c_double] * 7 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(_native.ptr(depths), n, H, W, _native.ptr(poses), float(f),
                 float(cx), float(cy), res, *box, float(trunc),
                 _native.ptr(out), _native.stream(dev))
    _native.check_launch(err, "tsdf_fuse")
    count("ops.tsdf_fuse.launches")
    return out


def tsdf_fuse(depths, poses, f: float, cx: float, cy: float, res: int,
              bbox, trunc: float) -> torch.Tensor:
    """Projective TSDF fusion of n depth views: depths (n, H, W) float32,
    poses (n, 4, 4) float64 world->camera, a res^3 grid over bbox (min x,
    min y, min z, max x, max y, max z), truncation `trunc` -> (res, res,
    res) float32 in [-1, 1], +1 where no view sees a voxel.

    A CUDA `depths` goes to the kernel (contiguous tensors of these types
    required), a CPU one to the plain version. The counter
    `ops.tsdf_fuse.launches` counts the kernel's launches."""
    poses, _ = _poses(poses)
    if depths.device.type == "cpu":
        return tsdf_fuse_plain(depths, poses, f, cx, cy, res, bbox, trunc)
    return _fuse_cuda(depths, poses, f, cx, cy, res, bbox, trunc)

