"""Write a protocol-shaped, multi-class synthetic dataset on disk, in the
layout the training and test loaders read:

  <root>/processed/<scene>/bbox.pkl + full_scan.npz
  <root>/splits/scannetv2_{train,val}.json        (`prep.scannet.build_splits`)
  <root>/scannet_splits/scannetv2_{train,val}.txt
  <root>/shapenet/point/<catid>/<sid>.npz         (canonical occupancies)
  <root>/shapenet/voxel/16/<catid>/<sid>.binvox
  <root>/shapenet/watertight_scaled_simplified/<catid>/<sid>.off

The port's counterpart of `tools/gen_synthetic_dataset.py`: the same
arguments and defaults, and the same draws from
`np.random.RandomState(--seed)` in the same order, so that a seed gives the
same files. Each of the 8 detection classes is a parametric occupancy
shape (slabs, legs, open cylinders, hollow basins) with `--variants`
jittered variants, each mirror-symmetric about its own y axis (the flip
augmentation's heading update needs it: x-flip pi - theta, y-flip -theta).
Each variant gets 100000 occupancy points (f16 + packed bits), a 16^3
binvox and a marching-cubes OFF mesh; each scene places 4-8 of them
(world = R_z(heading) @ (p * size) + center) among a floor, two walls and
noise blobs, `--points` points a scene (the loaders subsample to 80000).

Unlike `data.synthetic.write_scannet_scenes` (a cube at every object),
detection, completion, voxel IoU and the mesh mAP all see non-cube shapes.
The generator does numpy work only (no tensors), so it takes no `--device`.

Run: `python -m rfdnet_tpu_torch.tools.gen_synthetic_dataset --out DIR
[--train 128] [--val 32] [--points 120000] [--variants 4] [--seed 0]`.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..config import MEAN_SIZE_ARR, SHAPENETCLASSES, SHAPENETID2CLASS
from ..data.binvox import Voxels, write_binvox
from ..meshing.mesh import TriMesh
from ..meshing.native import marching_cubes
from ..prep.scannet import build_splits

# catid -> class name for the 8 detection classes
CATIDS = {
    "04379243": "table",
    "03001627": "chair",
    "02871439": "bookshelf",
    "04256520": "sofa",
    "02747177": "trash_bin",
    "02933112": "cabinet",
    "03211117": "display",
    "02808440": "bathtub",
}
# catid -> SHAPENETCLASSES index, and -> detection class index (0..7)
SHAPENET_CLS_ID = {catid: SHAPENETCLASSES.index(name)
                   for catid, name in CATIDS.items()}
CLASS_IND = {catid: SHAPENETID2CLASS[cid]
             for catid, cid in SHAPENET_CLS_ID.items()}


# --------------------------------------------------------------- primitives
def box(lo, hi):
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return lambda p: np.all((p >= lo) & (p <= hi), axis=-1)


def tube_z(r_out, r_in, z0, z1):
    """Open cylinder shell around the z axis (r_in=0 -> solid)."""

    def f(p):
        r = np.hypot(p[..., 0], p[..., 1])
        return ((r <= r_out) & (r >= r_in) & (p[..., 2] >= z0)
                & (p[..., 2] <= z1))

    return f


def union(*fns):
    return lambda p: np.any(np.stack([f(p) for f in fns]), axis=0)


def make_shape(cls_name: str, rng: np.random.RandomState):
    """One jittered canonical occupancy function spanning ~[-0.5, 0.5]^3
    per axis (z up). Returns occ(p: (..., 3)) -> bool.

    Every shape with a heading puts its asymmetric feature along +x and
    stays mirror-symmetric in y: the flip augmentation's heading update
    keeps labels consistent with the points only for such shapes."""
    u = rng.uniform
    if cls_name == "table":
        top = u(0.06, 0.16)       # top slab thickness
        leg = u(0.08, 0.18)       # leg width
        parts = [box([-0.5, -0.5, 0.5 - top], [0.5, 0.5, 0.5])]
        for sx in (-1, 1):
            for sy in (-1, 1):
                x0, x1 = sorted((sx * 0.5, sx * (0.5 - leg)))
                y0, y1 = sorted((sy * 0.5, sy * (0.5 - leg)))
                parts.append(box([x0, y0, -0.5], [x1, y1, 0.5 - top]))
        return union(*parts)
    if cls_name == "chair":
        seat_z = u(-0.15, 0.0)
        seat_t = u(0.06, 0.12)
        back_t = u(0.08, 0.14)
        leg = u(0.05, 0.1)
        parts = [
            # seat spans full xy
            box([-0.5, -0.5, seat_z], [0.5, 0.5, seat_z + seat_t]),
            # back at +x, up to z=+0.5
            box([0.5 - back_t, -0.5, seat_z], [0.5, 0.5, 0.5]),
        ]
        for sx in (-1, 1):
            for sy in (-1, 1):
                x0, x1 = sorted((sx * 0.5, sx * (0.5 - 2 * leg)))
                y0, y1 = sorted((sy * 0.5, sy * (0.5 - 2 * leg)))
                parts.append(box([x0, y0, -0.5], [x1, y1, seat_z]))
        return union(*parts)
    if cls_name == "bookshelf":
        panel = u(0.04, 0.08)
        n_shelves = rng.randint(3, 5)
        parts = [
            box([0.5 - panel, -0.5, -0.5], [0.5, 0.5, 0.5]),    # back (+x)
            box([-0.5, -0.5, -0.5], [0.5, -0.5 + panel, 0.5]),  # side panels
            box([-0.5, 0.5 - panel, -0.5], [0.5, 0.5, 0.5]),
        ]
        for i in range(n_shelves + 1):
            z = -0.5 + i * 1.0 / n_shelves
            parts.append(box([-0.5, -0.5, max(z - panel, -0.5)],
                             [0.5, 0.5, min(z + panel, 0.5)]))
        return union(*parts)
    if cls_name == "sofa":
        seat_top = u(-0.1, 0.05)
        back_t = u(0.12, 0.2)
        arm_w = u(0.1, 0.16)
        arm_top = u(0.15, 0.3)
        return union(
            box([-0.5, -0.5, -0.5], [0.5, 0.5, seat_top]),          # base
            box([0.5 - back_t, -0.5, -0.5], [0.5, 0.5, 0.5]),       # back (+x)
            box([-0.5, -0.5, -0.5], [0.5, -0.5 + arm_w, arm_top]),  # arms (y)
            box([-0.5, 0.5 - arm_w, -0.5], [0.5, 0.5, arm_top]),
        )
    if cls_name == "trash_bin":
        wall = u(0.06, 0.12)
        bottom = u(0.05, 0.1)
        return union(
            tube_z(0.5, 0.5 - wall, -0.5, 0.5),
            tube_z(0.5, 0.0, -0.5, -0.5 + bottom),
        )
    if cls_name == "cabinet":
        door = u(0.0, 0.04)  # slight front inset detail (front at +x)
        return union(
            box([-0.5, -0.5, -0.5], [0.5 - door, 0.5, 0.5]),
            box([-0.5, -0.4, -0.4], [0.5, 0.4, 0.4]),
        )
    if cls_name == "display":
        panel_t = u(0.08, 0.16)
        stand_w = u(0.1, 0.2)
        stand_h = u(0.2, 0.35)
        return union(
            # screen panel occupying the top part
            box([-0.5, -panel_t / 2, -0.5 + stand_h], [0.5, panel_t / 2, 0.5]),
            # stand column + foot
            box([-stand_w / 2, -stand_w / 2, -0.5],
                [stand_w / 2, stand_w / 2, -0.5 + stand_h]),
            box([-0.3, -0.5, -0.5], [0.3, 0.5, -0.4]),
        )
    if cls_name == "bathtub":
        wall = u(0.08, 0.14)
        bottom = u(0.1, 0.18)
        return union(
            box([-0.5, -0.5, -0.5], [0.5, 0.5, -0.5 + bottom]),  # floor
            box([-0.5, -0.5, -0.5], [-0.5 + wall, 0.5, 0.5]),    # walls
            box([0.5 - wall, -0.5, -0.5], [0.5, 0.5, 0.5]),
            box([-0.5, -0.5, -0.5], [0.5, -0.5 + wall, 0.5]),
            box([-0.5, 0.5 - wall, -0.5], [0.5, 0.5, 0.5]),
        )
    raise ValueError(cls_name)


# ------------------------------------------------------------ shape assets
def shape_mesh(occ_fn, res: int = 48):
    """Watertight canonical mesh: the host marching cubes over the binary
    field (+1 inside / -1 outside) padded by one -1 layer, iso 0."""
    ax = np.linspace(-0.55, 0.55, res + 1, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    field = np.where(occ_fn(pts), 1.0, -1.0).astype(np.float32)
    field = field.reshape(res + 1, res + 1, res + 1)
    padded = np.pad(field, 1, constant_values=-1.0)
    verts, tris = marching_cubes(padded, 0.0)
    verts = (verts - 1.0) / res * 1.1 - 0.55
    return verts.astype(np.float32), np.asarray(tris, np.int64)


def sample_surface(verts, tris, n, rng):
    """Uniform-by-area surface samples of a triangle mesh. The dtypes are
    the JAX tool's (areas in the vertices' dtype): `rng.choice`'s draws
    depend on `probs` to the last bit."""
    a, b, c = (verts[tris[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = area / area.sum()
    pick = rng.choice(len(tris), size=n, p=probs)
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[pick] + u * (b[pick] - a[pick]) + v * (c[pick] - a[pick])


def write_shape_assets(shapenet_root, catid, sid, occ_fn, rng,
                       n_points=100000):
    """One variant's files: occupancy points (f16 points, packed bits),
    16^3 binvox at the unpadded cube's cell centres, the OFF mesh.
    Returns the mesh (verts, tris)."""
    pdir = os.path.join(shapenet_root, "point", catid)
    vdir = os.path.join(shapenet_root, "voxel", "16", catid)
    wdir = os.path.join(shapenet_root, "watertight_scaled_simplified", catid)
    for d in (pdir, vdir, wdir):
        os.makedirs(d, exist_ok=True)

    pts = rng.uniform(-0.55, 0.55, (n_points, 3)).astype(np.float32)
    occ = occ_fn(pts).astype(np.uint8)
    np.savez(os.path.join(pdir, sid + ".npz"),
             points=pts.astype(np.float16), occupancies=np.packbits(occ))

    ax = -0.5 + (np.arange(16) + 0.5) / 16.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    grid_pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    vox = occ_fn(grid_pts).reshape(16, 16, 16)
    with open(os.path.join(vdir, sid + ".binvox"), "wb") as f:
        write_binvox(f, Voxels(vox, (16,) * 3, [-0.5, -0.5, -0.5], 1.0))

    verts, tris = shape_mesh(occ_fn)
    TriMesh(verts, tris).export(os.path.join(wdir, sid + ".off"))
    return verts, tris


# ---------------------------------------------------------------- scenes
def make_scene(rng, shapes, mean_size_arr, n_points,
               max_objects=8, extent=3.2):
    """One scene: floor + two walls + noise clutter + placed shapes.
    Returns (mesh_vertices, point_votes, instance_labels, bbox_items)."""
    n_obj = rng.randint(4, max_objects + 1)
    keys = list(shapes.keys())
    placed = []   # (catid, sid, center, size, heading)
    tries = 0
    while len(placed) < n_obj and tries < 200:
        tries += 1
        catid, sid = keys[rng.randint(len(keys))]
        size = mean_size_arr[CLASS_IND[catid]] * rng.uniform(0.8, 1.25, 3)
        center = np.array([
            rng.uniform(-extent * 0.8, extent * 0.8),
            rng.uniform(-extent * 0.8, extent * 0.8),
            size[2] / 2,
        ])
        r = 0.5 * np.hypot(size[0], size[1])
        if any(np.hypot(*(center[:2] - p[2][:2]))
               < r + 0.5 * np.hypot(p[3][0], p[3][1]) + 0.1 for p in placed):
            continue
        heading = rng.uniform(-np.pi, np.pi)
        placed.append((catid, sid, center, size, heading))

    # point budget: 30% background, rest split by surface area
    n_bg = int(n_points * 0.3)
    areas = []
    for catid, sid, center, size, heading in placed:
        verts, tris = shapes[(catid, sid)][1]
        a, b, c = (verts[tris[:, i]] * size for i in range(3))
        areas.append(
            0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum())
    areas = np.asarray(areas)
    n_each = np.maximum(
        (areas / areas.sum() * (n_points - n_bg)).astype(int), 256)

    pts_list, votes_list, inst_list = [], [], []
    # floor + walls + clutter
    n_floor = int(n_bg * 0.6)
    floor = np.stack([
        rng.uniform(-extent, extent, n_floor),
        rng.uniform(-extent, extent, n_floor),
        np.abs(rng.normal(0, 0.01, n_floor)),
    ], axis=1)
    n_wall = int(n_bg * 0.25)
    wall = np.stack([
        np.full(n_wall, -extent) + np.abs(rng.normal(0, 0.01, n_wall)),
        rng.uniform(-extent, extent, n_wall),
        rng.uniform(0, 2.4, n_wall),
    ], axis=1)
    wall2 = wall[: n_wall // 2].copy()
    wall2[:, [0, 1]] = wall2[:, [1, 0]]
    n_blob = n_bg - n_floor - n_wall
    blob_c = rng.uniform(-extent, extent,
                         (max(n_blob // 64, 1), 3)) * [1, 1, 0]
    blob_c[:, 2] = rng.uniform(0.1, 1.8, len(blob_c))
    blob = (blob_c[rng.randint(len(blob_c), size=n_blob)]
            + rng.normal(0, 0.08, (n_blob, 3)))
    bg = np.concatenate([floor, wall, wall2, blob])
    pts_list.append(bg)
    votes_list.append(np.zeros((len(bg), 10), np.float32))
    inst_list.append(np.zeros(len(bg), np.int32))

    bbox_items = []
    for i, (catid, sid, center, size, heading) in enumerate(placed):
        occ_fn, (verts, tris) = shapes[(catid, sid)]
        local = sample_surface(verts, tris, int(n_each[i]), rng) * size
        c, s = np.cos(heading), np.sin(heading)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        world = local @ R.T + center
        world += rng.normal(0, 0.004, world.shape)  # sensor noise
        vote = np.tile(center - world, (1, 3))
        votes = np.concatenate(
            [np.ones((len(world), 1)), vote], axis=1
        ).astype(np.float32)
        pts_list.append(world)
        votes_list.append(votes)
        inst_list.append(np.full(len(world), i + 1, np.int32))
        bbox_items.append({
            "box3D": np.concatenate([center, size, [heading]]).astype(
                np.float64),
            "cls_id": SHAPENET_CLS_ID[catid],
            "shapenet_catid": catid,
            "shapenet_id": sid,
            "instance_id": i + 1,
        })

    mesh_vertices = np.concatenate(pts_list).astype(np.float32)
    point_votes = np.concatenate(votes_list).astype(np.float32)
    instance_labels = np.concatenate(inst_list)
    # shuffle so subsampling is unbiased
    perm = rng.permutation(len(mesh_vertices))
    return (mesh_vertices[perm], point_votes[perm], instance_labels[perm],
            bbox_items)


def parse_args(argv=None):
    p = argparse.ArgumentParser("gen_synthetic_dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=128)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--points", type=int, default=120000)
    p.add_argument("--variants", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Write the dataset under `--out`; returns its root."""
    args = parse_args(argv)
    rng = np.random.RandomState(args.seed)
    root = args.out
    shapenet = os.path.join(root, "shapenet")
    processed = os.path.join(root, "processed")
    os.makedirs(processed, exist_ok=True)

    # shape library: variants per class, with all assets on disk
    shapes = {}
    for catid, name in CATIDS.items():
        for v in range(args.variants):
            sid = f"syn{v}"
            occ_fn = make_shape(name, rng)
            verts, tris = write_shape_assets(shapenet, catid, sid, occ_fn, rng)
            shapes[(catid, sid)] = (occ_fn, (verts, tris))
    print(f"shape library: {len(shapes)} variants "
          f"({len(CATIDS)} classes x {args.variants})")

    n_total = args.train + args.val
    scene_names = []
    for i in range(n_total):
        scene = f"scene{i:04d}_00"
        scene_names.append(scene)
        sd = os.path.join(processed, scene)
        os.makedirs(sd, exist_ok=True)
        mv, votes, inst, bbox_items = make_scene(
            rng, shapes, MEAN_SIZE_ARR, args.points)
        np.savez(os.path.join(sd, "full_scan.npz"), mesh_vertices=mv,
                 point_votes=votes, instance_labels=inst)
        with open(os.path.join(sd, "bbox.pkl"), "wb") as f:
            pickle.dump(bbox_items, f)
        if (i + 1) % 32 == 0:
            print(f"scenes: {i + 1}/{n_total}")

    scansplit = os.path.join(root, "scannet_splits")
    os.makedirs(scansplit, exist_ok=True)
    with open(os.path.join(scansplit, "scannetv2_train.txt"), "w") as f:
        f.write("\n".join(scene_names[: args.train]) + "\n")
    with open(os.path.join(scansplit, "scannetv2_val.txt"), "w") as f:
        f.write("\n".join(scene_names[args.train:]) + "\n")
    build_splits(processed, os.path.join(root, "splits"), scansplit)
    print(f"dataset at {root}: {args.train} train / {args.val} val, "
          f"{args.points} raw pts/scene")
    return root


if __name__ == "__main__":
    main()
