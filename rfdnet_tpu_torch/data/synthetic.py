"""Synthetic ScanNet-format scenes, in memory and on disk.

`synthetic_scene_batch` is the port's own copy of
`rfdnet_tpu/data/synthetic.py`: point clouds with the height feature,
MAX_NUM_OBJ-padded box labels, per-point votes and instance labels, and
per-object occupancy point sets and 16^3 voxels. `write_scannet_scenes`
writes such scenes in the layout that `data.scannet.ScanNetDataset`
reads, with a watertight mesh of each object for the mesh mAP, so that the
test path runs from files without the real datasets. `write_raw_scan2cad_scene`
writes the raw input of the ScanNet preparation (`prep.scannet`).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..config import CLASS_IDS, MEAN_SIZE_ARR, NUM_HEADING_BIN
from ..meshing.mesh import write_off
from .binvox import Voxels, write_binvox

MAX_NUM_OBJ = 64


def synthetic_scene_batch(
    rng: np.random.RandomState,
    batch_size: int = 2,
    num_points: int = 4096,
    num_objects: int = 4,
    num_obj_points: int = 256,
    num_heading_bin: int = 12,
    num_class: int = 8,
    mean_size_arr: np.ndarray | None = None,
    scene_extent: float = 4.0,
) -> dict:
    if mean_size_arr is None:
        mean_size_arr = np.full((num_class, 3), 0.8, dtype=np.float32)

    B = batch_size
    pc = np.zeros((B, num_points, 4), np.float32)
    center_label = np.zeros((B, MAX_NUM_OBJ, 3), np.float32)
    heading_class_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    heading_residual_label = np.zeros((B, MAX_NUM_OBJ), np.float32)
    size_class_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    size_residual_label = np.zeros((B, MAX_NUM_OBJ, 3), np.float32)
    sem_cls_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    box_label_mask = np.zeros((B, MAX_NUM_OBJ), np.float32)
    vote_label = np.zeros((B, num_points, 9), np.float32)
    vote_label_mask = np.zeros((B, num_points), np.int32)
    point_instance_labels = np.zeros((B, num_points), np.float32)
    object_instance_labels = np.zeros((B, MAX_NUM_OBJ), np.float32)
    object_points = np.zeros((B, MAX_NUM_OBJ, num_obj_points, 3), np.float32)
    object_points_occ = np.zeros((B, MAX_NUM_OBJ, num_obj_points), np.float32)
    # 16^3 canonical voxelization consistent with the occupancy labels
    # below (inside points uniform in [-0.45, 0.45]^3): a cell is occupied
    # iff its center lies in that box
    ax = -0.5 + 1.0 / 32 + np.arange(16) / 16.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    box_voxels = (
        (np.abs(gx) <= 0.45) & (np.abs(gy) <= 0.45) & (np.abs(gz) <= 0.45)
    ).astype(np.float32)
    object_voxels = np.zeros((B, MAX_NUM_OBJ, 16, 16, 16), np.float32)

    for b in range(B):
        n_bg = num_points - num_objects * (num_points // (num_objects + 1))
        per_obj = num_points // (num_objects + 1)
        # floor points
        pts = []
        floor = rng.uniform(-scene_extent, scene_extent, size=(n_bg, 3)).astype(
            np.float32)
        floor[:, 2] = 0.0
        pts.append(floor)
        for o in range(num_objects):
            cls = rng.randint(0, num_class)
            size = mean_size_arr[cls] * rng.uniform(0.7, 1.3, size=3)
            center = rng.uniform(-scene_extent * 0.7, scene_extent * 0.7, size=3)
            center[2] = size[2] / 2 + rng.uniform(0, 0.3)
            heading = rng.uniform(0, 2 * np.pi)
            # surface-ish points of the box (in canonical frame then rotated)
            local = rng.uniform(-0.5, 0.5, size=(per_obj, 3)) * size
            face = rng.randint(0, 3, size=per_obj)
            sgn = rng.choice([-0.5, 0.5], size=per_obj)
            local[np.arange(per_obj), face] = sgn * size[face]
            c, s = np.cos(heading), np.sin(heading)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            world = local @ R.T + center
            pts.append(world.astype(np.float32))

            start = n_bg + o * per_obj
            idx = slice(start, start + per_obj)
            center_label[b, o] = center
            hc, hr = _angle2class(heading, num_heading_bin)
            heading_class_label[b, o] = hc
            heading_residual_label[b, o] = hr
            size_class_label[b, o] = cls
            size_residual_label[b, o] = size - mean_size_arr[cls]
            sem_cls_label[b, o] = cls
            box_label_mask[b, o] = 1.0
            vote = center - world  # (per_obj, 3)
            vote_label[b, idx] = np.tile(vote, (1, 3))
            vote_label_mask[b, idx] = 1
            point_instance_labels[b, idx] = o + 1
            object_instance_labels[b, o] = o + 1

            # occupancy supervision in the padded unit cube (canonical frame)
            n_in = num_obj_points // 2
            p_in = rng.uniform(-0.45, 0.45, size=(n_in, 3)).astype(np.float32)
            p_out = rng.uniform(-0.55, 0.55, size=(num_obj_points - n_in, 3))
            object_points[b, o, :n_in] = p_in
            object_points[b, o, n_in:] = p_out
            object_points_occ[b, o, :n_in] = 1.0
            # outside points in [-0.55, 0.55]^3 may fall inside the box:
            # relabel them so supervision is consistent
            out_in_box = np.all(
                np.abs(object_points[b, o, n_in:]) <= 0.45, axis=-1)
            object_points_occ[b, o, n_in:] = out_in_box.astype(np.float32)
            object_voxels[b, o] = box_voxels

        all_pts = np.concatenate(pts, axis=0)[:num_points]
        pc[b, :, :3] = all_pts
        floor_height = np.percentile(all_pts[:, 2], 0.99)
        pc[b, :, 3] = all_pts[:, 2] - floor_height

    return {
        "point_clouds": pc,
        "center_label": center_label,
        "heading_class_label": heading_class_label,
        "heading_residual_label": heading_residual_label,
        "size_class_label": size_class_label,
        "size_residual_label": size_residual_label,
        "sem_cls_label": sem_cls_label,
        "box_label_mask": box_label_mask,
        "vote_label": vote_label,
        "vote_label_mask": vote_label_mask,
        "point_instance_labels": point_instance_labels,
        "object_instance_labels": object_instance_labels,
        "object_points": object_points,
        "object_points_occ": object_points_occ,
        "object_voxels": object_voxels,
    }


def _angle2class(angle, num_heading_bin):
    angle = angle % (2 * np.pi)
    angle_per_class = 2 * np.pi / num_heading_bin
    shifted = (angle + angle_per_class / 2) % (2 * np.pi)
    class_id = int(shifted / angle_per_class)
    residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
    return class_id, residual


def _object_points(rng, n: int):
    """An occupancy point set of the synthetic box object in the padded
    unit cube: n points inside [-0.45, 0.45]^3 (occupied), then n in the
    shell out to 0.55 (free), one random axis pushed into the shell."""
    inside = rng.uniform(-0.45, 0.45, size=(n, 3))
    shell = rng.uniform(-0.55, 0.55, size=(n, 3))
    axis = rng.randint(0, 3, size=n)
    shell[np.arange(n), axis] = (rng.choice([-1.0, 1.0], size=n)
                                 * rng.uniform(0.45, 0.55, size=n))
    points = np.concatenate([shell, inside]).astype(np.float32)
    occ = np.concatenate([np.zeros(n, bool), np.ones(n, bool)])
    return points, occ


def box_mesh(half: float = 0.45):
    """The closed 12-triangle surface of the cube [-half, half]^3 (the
    synthetic object's occupied set), outward-facing: (8, 3) vertices,
    (12, 3) int32 triangles."""
    corners = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                        for z in (-half, half)])
    # corner index = 4 x + 2 y + z; each face as two counter-clockwise
    # triangles seen from outside
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return corners, np.array(tris, dtype=np.int32)


def write_scannet_scenes(root: str, num_scenes: int, seed: int = 0,
                         num_points: int = 4096, num_objects: int = 4,
                         points_subsample=(1024, 1024)) -> dict:
    """Write `num_scenes` scenes of `synthetic_scene_batch` (one RandomState
    from `seed`, class mean sizes of the dataset) under `root`, in the
    layout `ScanNetDataset` reads:

        scenes/sceneNNNN_00/full_scan.npz   mesh_vertices (N, 3),
                                            point_votes (N, 10),
                                            instance_labels (N,)
        scenes/sceneNNNN_00/bbox.pkl        one dict a box: box3D [center,
                                            size, heading], cls_id (ShapeNet
                                            class index), shapenet_catid,
                                            shapenet_id, instance_id
        splits/scannetv2_val.json           [{scan, bbox}], paths relative
        splits/scannetv2_train.json         to the split's directory (both
                                            list every scene)
        shapenet/point/<catid>/<sid>.npz    points (M, 3), packed
                                            occupancies
        shapenet/voxel/16/<catid>/<sid>.binvox
        shapenet/watertight_scaled_simplified/<catid>/<sid>.off
                                            the object's cube (`box_mesh`)

    Each object's occupancy file holds as many free as occupied points,
    enough for the test mode's first `points_subsample` rows of each.
    Returns {"split": the splits directory, "shapenet_path": ...}."""
    rng = np.random.RandomState(seed)
    split_dir = os.path.join(root, "splits")
    shapenet = os.path.join(root, "shapenet")
    os.makedirs(split_dir, exist_ok=True)
    n_occ = max(points_subsample)
    entries = []
    for i in range(num_scenes):
        name = f"scene{i:04d}_00"
        scene_dir = os.path.join(root, "scenes", name)
        os.makedirs(scene_dir, exist_ok=True)
        b = synthetic_scene_batch(
            rng, batch_size=1, num_points=num_points, num_objects=num_objects,
            num_obj_points=16, num_heading_bin=NUM_HEADING_BIN,
            mean_size_arr=MEAN_SIZE_ARR)
        np.savez(os.path.join(scene_dir, "full_scan.npz"),
                 mesh_vertices=b["point_clouds"][0, :, :3],
                 point_votes=np.concatenate(
                     [b["vote_label_mask"][0, :, None].astype(np.float32),
                      b["vote_label"][0]], axis=1),
                 instance_labels=b["point_instance_labels"][0])
        angle_per_class = 2 * np.pi / NUM_HEADING_BIN
        boxes = []
        for o in range(num_objects):
            cls = int(b["sem_cls_label"][0, o])
            catid, sid = f"{CLASS_IDS[cls]:08d}", f"{name}_{o}"
            heading = (b["heading_class_label"][0, o] * angle_per_class
                       + b["heading_residual_label"][0, o])
            size = MEAN_SIZE_ARR[cls] + b["size_residual_label"][0, o]
            boxes.append({
                "box3D": np.concatenate(
                    [b["center_label"][0, o], size, [heading]]),
                "cls_id": CLASS_IDS[cls], "shapenet_catid": catid,
                "shapenet_id": sid,
                "instance_id": int(b["object_instance_labels"][0, o]),
            })
            points, occ = _object_points(rng, n_occ)
            point_dir = os.path.join(shapenet, "point", catid)
            voxel_dir = os.path.join(shapenet, "voxel", "16", catid)
            mesh_dir = os.path.join(shapenet, "watertight_scaled_simplified",
                                    catid)
            for d in (point_dir, voxel_dir, mesh_dir):
                os.makedirs(d, exist_ok=True)
            write_off(os.path.join(mesh_dir, sid + ".off"), *box_mesh())
            np.savez(os.path.join(point_dir, sid + ".npz"), points=points,
                     occupancies=np.packbits(occ))
            with open(os.path.join(voxel_dir, sid + ".binvox"), "wb") as f:
                write_binvox(f, Voxels(b["object_voxels"][0, o] > 0.5,
                                       (16,) * 3, [-0.5] * 3, 1.0))
        with open(os.path.join(scene_dir, "bbox.pkl"), "wb") as f:
            pickle.dump(boxes, f)
        entries.append({
            "scan": os.path.join("..", "scenes", name, "full_scan.npz"),
            "bbox": os.path.join("..", "scenes", name, "bbox.pkl"),
        })
    for split in ("train", "val"):
        with open(os.path.join(split_dir, f"scannetv2_{split}.json"),
                  "w") as f:
            json.dump(entries, f)
    return {"split": split_dir, "shapenet_path": shapenet}


RAW_SCENE = "scene0000_00"
# (synset, model id, Scan2CAD translation, rotation, scale) of the raw
# scene's CAD models: a chair and a table (detection classes) and an
# airplane (not one: the preparation skips it)
RAW_CADS = (
    ("03001627", "chair0", [1.0, 0.5, 0.4], [0.70710678, 0.70710678, 0, 0],
     [0.5, 0.9, 0.5]),
    ("04379243", "table0", [-0.8, -0.6, 0.35], [0.65328148, 0.65328148,
                                                0.27059805, 0.27059805],
     [1.2, 0.7, 0.8]),
    ("02691156", "plane0", [0.0, 1.5, 1.0], [1, 0, 0, 0], [0.3, 0.3, 0.3]),
)
RAW_SCAN_TRS = ([0.3, -0.2, 0.0], [0.98480775, 0, 0, 0.17364818],
                [1, 1, 1])


def _write_scan_ply(path: str, xyz, rgb) -> None:
    """A binary PLY of float xyz and uchar rgba vertices, as ScanNet's
    `_vh_clean_2.ply` (without its faces)."""
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(xyz)}"
            "\nproperty float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "property uchar alpha\nend_header\n")
    rec = np.empty(len(xyz),
                   dtype=[("xyz", "<f4", (3,)), ("rgba", "u1", (4,))])
    rec["xyz"] = xyz
    rec["rgba"][:, :3] = rgb
    rec["rgba"][:, 3] = 255
    with open(path, "wb") as f:
        f.write(head.encode() + rec.tobytes())


def write_raw_scan2cad_scene(root: str, seed: int = 0,
                             object_points: int = 400,
                             floor_points: int = 500):
    """The raw files of one ScanNet scene with its Scan2CAD annotation
    under `root`: `scans/<scene>/` (the scan's PLY, aggregation, segments
    and meta files; `object_points` points inside each CAD model's box and
    `floor_points` on the floor), a CAD `.obj` of each model under
    `shapenet/`, `labels.tsv`, `splits/` and `scan2cad.json`. Returns
    (the annotation, {scans, shapenet, tsv, splits}: their paths)."""
    from ..prep.scannet import make_M_from_tqs

    rng = np.random.RandomState(seed)
    scans, shapenet = os.path.join(root, "scans"), os.path.join(root,
                                                                "shapenet")
    folder = os.path.join(scans, RAW_SCENE)
    os.makedirs(folder)
    a = np.deg2rad(30.0)
    axis_align = np.eye(4)
    axis_align[:3, :3] = [[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    axis_align[:3, 3] = [0.5, -1.0, 0.0]
    M_scan = make_M_from_tqs(*RAW_SCAN_TRS)
    annotation = {"id_scan": RAW_SCENE,
                  "trs": dict(zip(("translation", "rotation", "scale"),
                                  RAW_SCAN_TRS)),
                  "aligned_models": []}
    aligned, segs, groups = [], [], []
    for k, (catid, cid, t, q, s) in enumerate(RAW_CADS):
        # the CAD model: a cloud of a box in ShapeNet's frame (y up)
        local = rng.uniform(-0.5, 0.5, (300, 3)) * [0.8, 1.0, 0.6]
        model_dir = os.path.join(shapenet, catid, cid, "models")
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "model_normalized.obj"), "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in local)
            f.write("f 1 2 3\n")
        annotation["aligned_models"].append(
            {"catid_cad": catid, "id_cad": cid,
             "trs": {"translation": t, "rotation": q, "scale": s}})
        # the scan's points of this object: the CAD placed in the aligned
        # frame, shrunk a little so that they lie inside its box
        T = axis_align @ np.linalg.inv(M_scan) @ make_M_from_tqs(t, q, s)
        inner = rng.uniform(-0.45, 0.45, (object_points, 3)) * [0.8, 1.0,
                                                                 0.6]
        aligned.append((np.c_[inner, np.ones(len(inner))] @ T.T)[:, :3])
        segs += [2 * k + (i % 2) for i in range(len(inner))]
        groups.append({"objectId": k, "label": ("chair", "table", "toy")[k],
                       "segments": [2 * k, 2 * k + 1]})
    floor = np.c_[rng.uniform(-2, 2, (floor_points, 2)),
                  np.zeros(floor_points)]
    aligned.append(floor)
    segs += [99] * len(floor)
    aligned = np.concatenate(aligned)
    raw = (np.c_[aligned, np.ones(len(aligned))] @ np.linalg.inv(
        axis_align).T)[:, :3]
    _write_scan_ply(os.path.join(folder, f"{RAW_SCENE}_vh_clean_2.ply"), raw,
                    rng.randint(0, 256, (len(raw), 3)))
    with open(os.path.join(folder, f"{RAW_SCENE}.aggregation.json"),
              "w") as f:
        json.dump({"segGroups": groups}, f)
    with open(os.path.join(
            folder, f"{RAW_SCENE}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": segs}, f)
    with open(os.path.join(folder, f"{RAW_SCENE}.txt"), "w") as f:
        f.write("axisAlignment = " + " ".join(
            repr(float(x)) for x in axis_align.ravel()) + "\n")
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w") as f:
        f.write("raw_category\tnyu40id\nchair\t5\ntable\t7\ntoy\tx\n")
    splits = os.path.join(root, "splits")
    os.makedirs(splits)
    with open(os.path.join(splits, "scannetv2_train.txt"), "w") as f:
        f.write(f"{RAW_SCENE}\nscene0001_00\n")
    with open(os.path.join(splits, "scannetv2_val.txt"), "w") as f:
        f.write("scene0002_00\n")
    with open(os.path.join(root, "scan2cad.json"), "w") as f:
        json.dump([annotation], f)
    return annotation, dict(scans=scans, shapenet=shapenet, tsv=tsv,
                            splits=splits)
