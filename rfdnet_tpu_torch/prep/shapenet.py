"""ShapeNet offline preparation (L0): watertighting, sampling, simplifying.

The port's own copy of `tools/prep/shapenet.py`, with the same arguments,
the same random draws and the same output tree under `--out_root`
(`pointcloud/`, `voxel/16/`, `point/`, `watertight_scaled/`,
`watertight_scaled_simplified/`, each with a folder a category):

stage *fuse*     normalise the mesh to the unit cube (padding 0.1), render
                 100 depth views of 640 x 640 (f = 640) from a Fibonacci
                 sphere, fuse a truncated SDF at `resolution`^3 and take
                 its zero level set by marching tetrahedra, back in the
                 original frame. Render and fusion are CUDA kernels on the
                 card (`ops.fusion`), every view in one launch each.
stage *sample*   100k surface points, 16^3 voxels, 100k occupancy points
                 labelled by `points_in_mesh`, and the mesh itself.
stage *simplify* QEM simplification to `--nfaces`.

Run: `python -m rfdnet_tpu_torch.prep.shapenet --in_root <ShapeNet root>
--out_root <dir>`. The card does render and fusion model by model in the
main process; tetrahedra, sampling, containment, voxels, QEM and the
files run on the host in a pool of `--workers` processes (started by
`spawn`: a forked child cannot use CUDA, and threads would queue on the
interpreter lock, which the OFF writer and the sampling hold); the card
waits while two jobs a worker are in flight. `--device cpu` renders and
fuses with the plain versions instead; without it and without a card the
run raises. A model that does not load or fails a host stage is reported
and skipped, as in the JAX tool, and the run then exits with 1; an error
of the device ends the run.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

import numpy as np
import torch

from .. import resolve_device
from ..data.binvox import Voxels, write_binvox
from ..meshing.mesh import TriMesh
from ..meshing.native import (
    fill_interior,
    marching_tetrahedra,
    points_in_mesh,
    simplify_mesh,
    voxelize_surface,
)
from ..ops.fusion import render_depth, tsdf_fuse

FOCAL = 640.0
IMAGE = 640
N_VIEWS = 100
PADDING = 0.1
# the host stages' jobs in flight for each worker process: the parent
# holds each one's grid (67 MB at 256^3) until it ends
JOBS_PER_WORKER = 2
STAGES = ("render", "fuse", "tetrahedra", "sample", "containment",
          "simplify")
OUT_DIRS = (("pointcloud", "pointcloud"), ("voxel", "voxel/16"),
            ("point", "point"), ("watertight_scaled", "watertight_scaled"),
            ("simplified", "watertight_scaled_simplified"))


def fibonacci_views(n_views: int = N_VIEWS) -> np.ndarray:
    """Evenly spread unit viewpoints."""
    rnd = 1.0
    points = []
    offset = 2.0 / n_views
    increment = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        y = ((i * offset) - 1) + (offset / 2)
        r = np.sqrt(1 - y * y)
        phi = ((i + rnd) % n_views) * increment
        points.append([np.cos(phi) * r, y, np.sin(phi) * r])
    return np.array(points)


def look_at_pose(eye: np.ndarray) -> np.ndarray:
    """World->camera 4x4 for a camera at `eye` looking at the origin."""
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: x right, y down, z forward
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = -R @ eye
    return M


def _clock(dev: torch.device) -> float:
    """The host clock once the device's queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def fuse_tsdf(mesh: TriMesh, resolution: int = 256, n_views: int = N_VIEWS,
              truncation_factor: float = 10.0, device=None, ms=None):
    """The card's part of `watertight_fuse`: the mesh normalised, rendered
    from `n_views` views and fused. Returns (tsdf (res, res, res) float32
    numpy, center, scale); `ms` (a dict) gets the render and fuse times."""
    dev = resolve_device(device)
    ms = {} if ms is None else ms
    verts = np.asarray(mesh.vertices)
    center = (verts.max(0) + verts.min(0)) / 2.0
    scale = (verts.max(0) - verts.min(0)).max() / (1 - PADDING)
    norm = (verts - center) / scale  # in [-0.45, 0.45]
    poses = np.stack([look_at_pose(eye)
                      for eye in fibonacci_views(n_views) * 2.0])

    t0 = _clock(dev)
    poses_t = torch.from_numpy(poses).to(dev)
    depths = render_depth(
        torch.from_numpy(norm).to(dev),
        torch.from_numpy(np.ascontiguousarray(mesh.faces, np.int32)).to(dev),
        poses_t, FOCAL, IMAGE / 2.0, IMAGE / 2.0, IMAGE, IMAGE)
    t1 = _clock(dev)
    truncation = truncation_factor * (1.0 / resolution)
    bbox = (-0.5, -0.5, -0.5, 0.5, 0.5, 0.5)
    tsdf = tsdf_fuse(depths, poses_t, FOCAL, IMAGE / 2.0, IMAGE / 2.0,
                     resolution, bbox, truncation).cpu().numpy()
    t2 = time.perf_counter()
    ms["render"], ms["fuse"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    return tsdf, center, scale


def tsdf_mesh(tsdf: np.ndarray, center, scale) -> TriMesh:
    """The host's part of `watertight_fuse`: the zero level set of the TSDF
    (+ outside) by marching tetrahedra, in the original frame."""
    resolution = tsdf.shape[0]
    v, f = marching_tetrahedra(-tsdf, 0.0)
    if len(v) == 0:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3)))
    v = (v + 0.5) / resolution - 0.5  # index -> normalized coords
    return TriMesh(v * scale + center, f)


def watertight_fuse(mesh: TriMesh, resolution: int = 256,
                    n_views: int = N_VIEWS, truncation_factor: float = 10.0,
                    device=None):
    """Mesh -> watertight mesh by multi-view depth and TSDF fusion. Returns
    (mesh, loc, scale) with the output in the ORIGINAL frame and loc/scale
    recording the normalization."""
    tsdf, center, scale = fuse_tsdf(mesh, resolution, n_views,
                                    truncation_factor, device)
    return tsdf_mesh(tsdf, center, scale), center, scale


def sample_surface(mesh: TriMesh, n: int, rng) -> np.ndarray:
    """Area-weighted surface sampling."""
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    idx = rng.choice(len(f), size=n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return (
        a[idx] * (1 - r1) + b[idx] * r1 * (1 - r2) + c[idx] * r1 * r2
    )


def sample_model(mesh: TriMesh, out_dirs: dict, catid: str, modelname: str,
                 points_size: int = 100_000, uniform_ratio: float = 0.5,
                 sigma: float = 0.01, voxel_res: int = 16, seed: int = 0,
                 ms=None):
    """The sample stage's files for one watertight mesh. `ms` (a dict)
    gets the containment test's time and the rest's as `sample`."""
    ms = {} if ms is None else ms
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    verts = np.asarray(mesh.vertices)
    loc = (verts.max(0) + verts.min(0)) / 2.0
    scale = (verts.max(0) - verts.min(0)).max() / (1 - PADDING)
    unit = TriMesh((verts - loc) / scale, mesh.faces)

    # pointcloud/: surface points
    pc = sample_surface(unit, points_size, rng).astype(np.float16)
    np.savez(
        os.path.join(out_dirs["pointcloud"], f"{modelname}.npz"),
        points=pc, loc=loc.astype(np.float32), scale=np.float32(scale),
    )

    # voxel/<res>/: binvox occupancy of the unit mesh
    vsize = 1.0 / voxel_res
    surf = voxelize_surface(
        unit.vertices, unit.faces, np.full(3, -0.5), vsize,
        (voxel_res,) * 3,
    )
    vox = (surf | fill_interior(surf)).astype(bool)
    with open(
        os.path.join(out_dirs["voxel"], f"{modelname}.binvox"), "wb"
    ) as fh:
        write_binvox(fh, Voxels(vox, (voxel_res,) * 3, list(loc), scale))

    # point/: occupancy supervision points
    n_uniform = int(points_size * uniform_ratio)
    n_surface = points_size - n_uniform
    boxsize = 1 + PADDING
    pts_u = boxsize * (rng.rand(n_uniform, 3) - 0.5)
    pts_s = sample_surface(unit, n_surface, rng)
    pts_s += sigma * rng.randn(n_surface, 3)
    pts = np.concatenate([pts_u, pts_s]).astype(np.float32)
    t1 = time.perf_counter()
    occ = points_in_mesh(unit.vertices, unit.faces, pts)
    t2 = time.perf_counter()
    np.savez(
        os.path.join(out_dirs["point"], f"{modelname}.npz"),
        points=pts.astype(np.float16),
        occupancies=np.packbits(occ),
        loc=loc.astype(np.float32), scale=np.float32(scale),
    )

    # watertight_scaled/: mesh back at original scale
    mesh.export(
        os.path.join(out_dirs["watertight_scaled"], f"{modelname}.off")
    )
    ms["containment"] = (t2 - t1) * 1e3
    ms["sample"] = (time.perf_counter() - t0) * 1e3 - ms["containment"]


def make_out_dirs(out_root: str, catid: str) -> dict:
    out_dirs = {}
    for key, sub in OUT_DIRS:
        d = os.path.join(out_root, sub, catid)
        os.makedirs(d, exist_ok=True)
        out_dirs[key] = d
    return out_dirs


def finish_model(tsdf, center, scale, out_root: str, catid: str,
                 modelname: str, nfaces: int, ms: dict) -> dict:
    """The host stages of one model: tetrahedra, sampling (with the
    containment test), simplification, and their files. Returns `ms` with
    their times."""
    t0 = time.perf_counter()
    wt = tsdf_mesh(tsdf, center, scale)
    ms["tetrahedra"] = (time.perf_counter() - t0) * 1e3
    out_dirs = make_out_dirs(out_root, catid)
    sample_model(wt, out_dirs, catid, modelname, ms=ms)
    t1 = time.perf_counter()
    sv, st = simplify_mesh(wt.vertices, wt.faces, nfaces)
    TriMesh(sv, st).export(
        os.path.join(out_dirs["simplified"], f"{modelname}.off")
    )
    ms["simplify"] = (time.perf_counter() - t1) * 1e3
    return ms


def _finish_timed(*args) -> tuple:
    """`finish_model` in a worker: its stage times and when it ended."""
    return finish_model(*args), time.time()


def find_models(in_root: str) -> list:
    """(path, catid, model) of each model under in_root/<catid>/<model>/
    (`model.off` or `models/model_normalized.off`), sorted."""
    found = []
    for catid in sorted(os.listdir(in_root)):
        cdir = os.path.join(in_root, catid)
        if not os.path.isdir(cdir):
            continue
        for model in sorted(os.listdir(cdir)):
            for cand in ("model.off", "models/model_normalized.off"):
                path = os.path.join(cdir, model, cand)
                if os.path.exists(path):
                    found.append((path, catid, model))
                    break
    return found


def load_model(path: str) -> TriMesh:
    """A model's mesh; raises ValueError for a file without triangles."""
    mesh = TriMesh.load(path)
    if len(mesh.faces) == 0:
        raise ValueError(f"{path}: no triangles")
    return mesh


def run(in_root: str, out_root: str, resolution: int = 256,
        nfaces: int = 5000, workers: int = 8, device=None) -> list:
    """Every model under in_root: render and fuse on `device` here, model
    by model, the host stages of the models in `workers` processes, with
    at most JOBS_PER_WORKER jobs a worker in flight. Returns one (catid,
    model name, ok, error message, stage ms) a model, in order; `stage ms`
    adds `total`, the model's time from its load to its last file. A model
    that does not load or fails a host stage is reported so; an error of
    the device (a kernel that does not build or launch) is raised."""
    dev = resolve_device(device)
    jobs = find_models(in_root)
    print(f"{len(jobs)} models", flush=True)
    workers = max(1, workers)
    results = [None] * len(jobs)
    running = {}  # future -> (model's index, its start on the shared clock)

    def collect(done):
        for job in done:
            i, t0 = running.pop(job)
            err, ms = job.exception(), {}
            if err is None:
                ms, end = job.result()
                ms["total"] = (end - t0) * 1e3
            results[i] = (*jobs[i][1:], err is None,
                          "" if err is None else str(err), ms)

    with ProcessPoolExecutor(workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        for i, (path, catid, model) in enumerate(jobs):
            while len(running) >= JOBS_PER_WORKER * workers:
                collect(wait(running, return_when=FIRST_COMPLETED).done)
            ms, t0 = {}, time.time()  # a clock the workers share
            try:
                mesh = load_model(path)
            except Exception as e:  # a bad model is reported and skipped
                results[i] = (catid, model, False, str(e), {})
                continue
            tsdf, center, scale = fuse_tsdf(mesh, resolution, device=dev,
                                            ms=ms)
            running[pool.submit(_finish_timed, tsdf, center, scale, out_root,
                                catid, model, nfaces, ms)] = (i, t0)
        collect(wait(running).done)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser("shapenet prep: fuse + sample + simplify")
    p.add_argument("--in_root", required=True,
                   help="ShapeNetCore.v2 root (catid/modelid/models/*.off)")
    p.add_argument("--out_root", required=True)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--nfaces", type=int, default=5000)
    p.add_argument("--workers", type=int, default=8,
                   help="processes of the host stages")
    p.add_argument("--device", default=None,
                   help="the device of render and fusion (default: the "
                        "current CUDA card; cpu: the plain versions)")
    args = p.parse_args(argv)
    results = run(args.in_root, args.out_root, args.resolution, args.nfaces,
                  args.workers, args.device)
    for catid, model, ok, err, ms in results:
        if not ok:
            print(f"FAILED {model}: {err}", flush=True)
        print(json.dumps({"catid": catid, "model": model, "ok": ok,
                          "stage_ms": ms}), flush=True)
    return 0 if all(r[2] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
