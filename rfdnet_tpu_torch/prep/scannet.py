"""ScanNet + Scan2CAD offline preparation (L0).

The port's own copy of `tools/prep/scannet.py`, with the same arguments
and the same files: for each Scan2CAD annotation, axis-align the scan,
place each aligned ShapeNet CAD model in the scan's frame, rectify its axes
to gravity, write a 7-DoF box [center, size, heading], match it to a ScanNet
instance by cuboid IoU and accumulate up to 3 centre votes a point
(N x 10: a mask and 3 votes) into `<out_root>/<scene>/bbox.pkl` and
`full_scan.npz`; then the per-class mean box sizes (`scannet_means.npz`)
and the train/val split JSONs.

Run: `python -m rfdnet_tpu_torch.prep.scannet --scan2cad ... --scans_root
... --shapenet_root ... --label_tsv ... --out_root ...`. The parsing and
the box geometry are host numpy; the scan's points, their box membership
and the votes live on `--device` (the current CUDA card by default; `cpu`
to stay on the host; without either a card or `--device cpu` the run
raises). Scenes run on `--workers` threads. A scene whose files are
missing or malformed is reported and skipped, and the run then exits with
1; an error of the device ends the run.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from ..config import CLASS_IDS, SHAPENET_ID_MAP, SHAPENETCLASSES
from ..eval.box_util import poly_area, polygon_clip

OBJ_CLASS_IDS = np.array(CLASS_IDS)


# ------------------------------------------------------------- geometry
def quaternion_matrix(q) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])


def make_M_from_tqs(t, q, s) -> np.ndarray:
    """Scan2CAD translation, rotation quaternion and scale -> 4x4."""
    M = np.eye(4)
    M[:3, :3] = quaternion_matrix(q) @ np.diag(s)
    M[:3, 3] = t
    return M


def normalize(v):
    return v / np.linalg.norm(v)


def get_box_corners(center, vectors):
    """Center + half-edge vectors -> 8 corners, bottom 0-3 / top 4-7."""
    c = np.asarray(center)
    v0, v1, v2 = np.asarray(vectors)
    return np.array([
        c - v0 - v1 - v2, c + v0 - v1 - v2, c + v0 + v1 - v2, c - v0 + v1 - v2,
        c - v0 - v1 + v2, c + v0 - v1 + v2, c + v0 + v1 + v2, c - v0 + v1 + v2,
    ])


def get_iou_cuboid(cu1: np.ndarray, cu2: np.ndarray) -> float:
    """Cuboid IoU: the intersection of the bird's-eye polygons times the
    overlap in z, over the union."""
    p1 = [tuple(cu1[i, :2]) for i in range(4)]
    p2 = [tuple(cu2[i, :2]) for i in range(4)]
    inter = polygon_clip(p1, p2)
    if inter is None:
        inter_2d = 0.0
    else:
        inter = np.array(inter)
        inter_2d = poly_area(inter[:, 0], inter[:, 1])
    zmin = max(cu1[0, 2], cu2[0, 2])
    zmax = min(cu1[4, 2], cu2[4, 2])
    inter_vol = inter_2d * max(0.0, zmax - zmin)
    a1 = poly_area(np.array([p[0] for p in p1]), np.array([p[1] for p in p1]))
    a2 = poly_area(np.array([p[0] for p in p2]), np.array([p[1] for p in p2]))
    vol1 = a1 * (cu1[4, 2] - cu1[0, 2])
    vol2 = a2 * (cu2[4, 2] - cu2[0, 2])
    denom = vol1 + vol2 - inter_vol
    return inter_vol / denom if denom > 0 else 0.0


def points_in_obb(points: torch.Tensor, corners) -> torch.Tensor:
    """Whether each of the (N, 3) float64 points lies inside the box of
    `corners` (numpy (8, 3), bottom 0-3, top 4-7), within 1e-9 of its box
    coordinates; on the points' device."""
    corners = np.asarray(corners, dtype=np.float64)
    origin = corners[0]
    M = np.stack([corners[1] - origin, corners[3] - origin,
                  corners[4] - origin], axis=1)  # local -> world
    inv_t = torch.from_numpy(np.linalg.inv(M).T.copy()).to(points.device)
    local = (points - torch.from_numpy(origin).to(points.device)) @ inv_t
    return ((local >= -1e-9) & (local <= 1 + 1e-9)).all(dim=1)


# ---------------------------------------------------------------- loaders
def read_mesh_vertices_rgb(path: str) -> np.ndarray:
    """ScanNet `_vh_clean_2.ply` -> (N, 6) xyz + rgb (a binary
    little-endian PLY with x y z red green blue [alpha ...] vertex
    properties)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    n_vert = 0
    props = []
    cur = None
    tmap = {"float": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
            "int": "<i4", "uint": "<u4", "short": "<i2", "ushort": "<u2",
            "char": "i1"}
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
        elif parts[0] == "property" and cur == "vertex":
            props.append((parts[2], tmap[parts[1]]))
    raw = np.frombuffer(data, dtype=np.dtype(props), count=n_vert, offset=end)
    out = np.zeros((n_vert, 6), np.float64)
    for i, k in enumerate(["x", "y", "z", "red", "green", "blue"]):
        out[:, i] = raw[k]
    return out


def read_label_map(tsv_path: str, label_from="raw_category",
                   label_to="nyu40id") -> dict:
    """scannetv2-labels.combined.tsv -> {raw label: mapped id}."""
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                mapping[row[label_from]] = int(row[label_to])
            except (ValueError, KeyError):
                mapping[row[label_from]] = 0
    return mapping


def read_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.array(verts)


def load_axis_align_matrix(meta_file: str) -> np.ndarray:
    with open(meta_file) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = [float(x) for x in
                        line.rstrip().strip("axisAlignment = ").split(" ")]
                return np.array(vals).reshape(4, 4)
    return np.eye(4)


def export_scan(mesh_file, agg_file, seg_file, meta_file, label_map):
    """Aligned vertices, per-vertex semantic and instance labels, and
    per-instance axis-aligned boxes [center, size, label] of one scan."""
    mesh_vertices = read_mesh_vertices_rgb(mesh_file)
    axis_align = load_axis_align_matrix(meta_file)
    pts = np.concatenate(
        [mesh_vertices[:, :3], np.ones((len(mesh_vertices), 1))], axis=1
    )
    mesh_vertices[:, :3] = (pts @ axis_align.T)[:, :3]

    with open(agg_file) as f:
        agg = json.load(f)
    object_id_to_segs, label_to_segs = {}, {}
    for obj in agg["segGroups"]:
        oid = obj["objectId"] + 1
        object_id_to_segs[oid] = obj["segments"]
        label_to_segs.setdefault(obj["label"], []).extend(obj["segments"])
    with open(seg_file) as f:
        seg = json.load(f)
    seg_to_verts = {}
    for v, s in enumerate(seg["segIndices"]):
        seg_to_verts.setdefault(s, []).append(v)
    num_verts = len(seg["segIndices"])

    label_ids = np.zeros(num_verts, np.uint32)
    for label, segs in label_to_segs.items():
        lid = label_map.get(label, 0)
        for s in segs:
            label_ids[seg_to_verts.get(s, [])] = lid
    instance_ids = np.zeros(num_verts, np.uint32)
    obj_to_label = {}
    for oid, segs in object_id_to_segs.items():
        for s in segs:
            verts = seg_to_verts.get(s, [])
            instance_ids[verts] = oid
            if oid not in obj_to_label and verts:
                obj_to_label[oid] = label_ids[verts[0]]
    bboxes = []
    for oid in sorted(object_id_to_segs):
        pc = mesh_vertices[instance_ids == oid, :3]
        if len(pc) == 0:
            bboxes.append(np.zeros(7))
            continue
        mn, mx = pc.min(0), pc.max(0)
        bboxes.append(np.concatenate(
            [(mn + mx) / 2, mx - mn, [obj_to_label.get(oid, 0)]]
        ))
    return mesh_vertices, label_ids, instance_ids, np.array(bboxes)


# ------------------------------------------------------------------ votes
def box_corners_7dof(box3D) -> np.ndarray:
    """The 8 corners of a [center, size, heading] box."""
    o = box3D[6]
    axis = np.array([[np.cos(o), np.sin(o), 0],
                     [-np.sin(o), np.cos(o), 0], [0, 0, 1]])
    return get_box_corners(box3D[:3], np.diag(box3D[3:6] / 2.0) @ axis)


def accumulate_votes(box3D, mesh_vertices: torch.Tensor,
                     point_votes: torch.Tensor,
                     point_vote_idx: torch.Tensor) -> None:
    """Up to 3 centre votes a point inside the oriented box, in place:
    mesh_vertices (N, >=3) float64, point_votes (N, 10) float64 (the mask,
    then 3 votes; a point's first vote fills all three), point_vote_idx
    (N,) int32, the next vote slot of each point; all on one device."""
    inds = points_in_obb(mesh_vertices[:, :3], box_corners_7dof(box3D))
    point_votes[inds, 0] = 1
    sel = inds.nonzero().squeeze(1)
    center = torch.from_numpy(np.asarray(box3D[:3], np.float64)).to(
        mesh_vertices.device)
    votes = center[None] - mesh_vertices[sel, :3]
    slot = point_vote_idx[sel]
    for k in range(3):
        here = slot == k
        rows, v = sel[here], votes[here]
        point_votes[rows, 3 * k + 1:3 * k + 4] = v
        if k == 0:
            point_votes[rows, 4:7] = v
            point_votes[rows, 7:10] = v
    point_vote_idx[sel] = torch.clamp(slot + 1, max=2)


# --------------------------------------------------------------- pipeline
def cad_box(model: dict, T: np.ndarray, shapenet_root: str):
    """A CAD model's 7-DoF box [center, size, heading] in the scan's frame
    (T: CAD -> scan), its axes rectified to gravity."""
    catid = model["catid_cad"]
    obj_points = read_obj_vertices(os.path.join(
        shapenet_root, catid, model["id_cad"], "models",
        "model_normalized.obj"))
    center = (obj_points.max(0) + obj_points.min(0)) / 2.0
    axis_pts = np.array([
        center, center - [0, 0, 1], center - [1, 0, 0], center + [0, 1, 0],
    ])
    tp = (np.concatenate([axis_pts, np.ones((4, 1))], axis=1) @ T.T)[:, :3]
    center_t = tp[0]
    axes_t = np.array([
        normalize(tp[1] - tp[0]),  # forward
        normalize(tp[2] - tp[0]),  # left
        normalize(tp[3] - tp[0]),  # up
    ])
    up_id = int(np.argmax(axes_t[:, 2]))
    fwd_id = 0 if up_id != 0 else 1
    left_id = int(np.setdiff1d([0, 1, 2], [up_id, fwd_id])[0])
    if np.linalg.norm(axes_t[fwd_id][:2]) < 1e-8:
        # the chosen forward axis is vertical: the other horizontal axis
        # is forward
        fwd_id, left_id = left_id, fwd_id
    fwd = normalize(np.array([*axes_t[fwd_id][:2], 0.0]))
    pts_t = np.concatenate(
        [obj_points, np.ones((len(obj_points), 1))], axis=1
    ) @ T.T
    coords = (pts_t[:, :3] - center_t) @ axes_t.T
    sizes = coords.max(0) - coords.min(0)
    return np.concatenate([
        center_t, sizes[[fwd_id, left_id, up_id]],
        [np.arctan2(fwd[1], fwd[0])],
    ])


def generate_scene(annotation: dict, scans_root: str, shapenet_root: str,
                   label_map: dict, out_root: str, device=None):
    """One Scan2CAD annotation -> bbox.pkl + full_scan.npz, the votes on
    `device`. Returns the per-class box sizes, or None when the scene was
    done before or has no object of the detection classes."""
    dev = resolve_device(device)
    scene = annotation["id_scan"]
    out_dir = os.path.join(out_root, scene)
    os.makedirs(out_dir, exist_ok=True)
    bbox_path = os.path.join(out_dir, "bbox.pkl")
    scan_path = os.path.join(out_dir, "full_scan.npz")
    if os.path.isfile(bbox_path) and os.path.isfile(scan_path):
        return None

    folder = os.path.join(scans_root, scene)
    meta = os.path.join(folder, scene + ".txt")
    axis_align = load_axis_align_matrix(meta)
    Mscan = make_M_from_tqs(
        annotation["trs"]["translation"], annotation["trs"]["rotation"],
        annotation["trs"]["scale"],
    )
    R_transform = axis_align @ np.linalg.inv(Mscan)

    mesh_vertices, _, instance_labels, instance_bboxes = export_scan(
        os.path.join(folder, scene + "_vh_clean_2.ply"),
        os.path.join(folder, scene + ".aggregation.json"),
        os.path.join(folder, scene + "_vh_clean_2.0.010000.segs.json"),
        meta, label_map,
    )

    N = len(mesh_vertices)
    vertices = torch.from_numpy(mesh_vertices).to(dev)
    point_votes = torch.zeros((N, 10), dtype=torch.float64, device=dev)
    point_vote_idx = torch.zeros(N, dtype=torch.int32, device=dev)
    mean_sizes = {int(c): [] for c in OBJ_CLASS_IDS}
    instances = []

    for model in annotation["aligned_models"]:
        catid = model["catid_cad"]
        cls_id = SHAPENETCLASSES.index(SHAPENET_ID_MAP[catid[1:]])
        if cls_id not in OBJ_CLASS_IDS:
            continue
        Mcad = make_M_from_tqs(
            model["trs"]["translation"], model["trs"]["rotation"],
            model["trs"]["scale"],
        )
        box3D = cad_box(model, R_transform @ Mcad, shapenet_root)
        mean_sizes[cls_id].append(box3D[3:6])

        cad_corners = box_corners_7dof(box3D)
        best_iou, best_id = 0.0, 0
        for inst_id, ib in enumerate(instance_bboxes):
            sc = get_box_corners(ib[:3], np.diag(ib[3:6]) / 2.0)
            iou = get_iou_cuboid(cad_corners, sc)
            if iou > best_iou:
                best_iou, best_id = iou, inst_id + 1

        instances.append({
            "box3D": box3D, "cls_id": cls_id,
            "shapenet_catid": catid, "shapenet_id": model["id_cad"],
            "instance_id": best_id, "box_corners": cad_corners,
        })
        accumulate_votes(box3D, vertices, point_votes, point_vote_idx)

    if not instances:
        return None
    with open(bbox_path, "wb") as f:
        pickle.dump(instances, f, protocol=pickle.HIGHEST_PROTOCOL)
    np.savez(
        scan_path, mesh_vertices=mesh_vertices,
        point_votes=point_votes.cpu().numpy(),
        instance_labels=instance_labels,
    )
    return mean_sizes


def build_splits(out_root: str, split_dir: str, scannet_split_dir: str):
    """Join the processed scenes with the official train/val scene lists
    into `scannetv2_{train,val}.json` under split_dir."""
    os.makedirs(split_dir, exist_ok=True)
    processed = {
        d for d in os.listdir(out_root)
        if os.path.isfile(os.path.join(out_root, d, "bbox.pkl"))
    }

    def rel(target: str) -> str:
        # relative to split_dir (the dataset resolves a relative entry
        # against its split folder), through real paths on both sides so
        # that a symlinked folder gives no wrong ../; absolute when the
        # relative form does not lead back to the file
        target = os.path.realpath(target)
        relative = os.path.relpath(target, os.path.realpath(split_dir))
        if os.path.exists(os.path.join(split_dir, relative)):
            return relative
        return target

    for split in ("train", "val"):
        txt = os.path.join(scannet_split_dir, f"scannetv2_{split}.txt")
        with open(txt) as f:
            wanted = [line.strip() for line in f if line.strip()]
        entries = [
            {
                "scan": rel(os.path.join(out_root, s, "full_scan.npz")),
                "bbox": rel(os.path.join(out_root, s, "bbox.pkl")),
            }
            for s in wanted if s in processed
        ]
        out = os.path.join(split_dir, f"scannetv2_{split}.json")
        with open(out, "w") as f:
            json.dump(entries, f)
        print(f"{split}: {len(entries)} scenes")


def mean_sizes_array(all_sizes) -> np.ndarray:
    """(classes, 3) mean box size of each detection class over the scenes'
    size lists (zeros for a class never seen)."""
    mean_arr = np.zeros((len(OBJ_CLASS_IDS), 3))
    for i, cls_id in enumerate(OBJ_CLASS_IDS):
        rows = sum(
            [s[int(cls_id)] for s in all_sizes if s is not None], []
        )
        if rows:
            mean_arr[i] = np.mean(rows, axis=0)
    return mean_arr


def main(argv=None) -> int:
    p = argparse.ArgumentParser("scannet + scan2cad prep")
    p.add_argument("--scan2cad", required=True,
                   help="full_annotations.json from Scan2CAD")
    p.add_argument("--scans_root", required=True, help="ScanNet scans/ dir")
    p.add_argument("--shapenet_root", required=True,
                   help="ShapeNetCore.v2 root")
    p.add_argument("--label_tsv", required=True,
                   help="scannetv2-labels.combined.tsv")
    p.add_argument("--out_root", required=True)
    p.add_argument("--splits_out", default=None)
    p.add_argument("--scannet_splits", default=None,
                   help="dir with scannetv2_{train,val}.txt")
    p.add_argument("--workers", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="the device of the votes (default: the current "
                        "CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with open(args.scan2cad) as f:
        annotations = json.load(f)
    label_map = read_label_map(args.label_tsv)

    failed = []

    def job(ann):
        try:
            return generate_scene(ann, args.scans_root, args.shapenet_root,
                                  label_map, args.out_root, dev)
        except (OSError, ValueError, KeyError, IndexError) as e:
            # a scene whose files are missing or malformed is reported and
            # skipped; an error of the device (a RuntimeError) ends the run
            print(f"FAILED {ann.get('id_scan')}: {e}")
            failed.append(ann.get("id_scan"))
            return None

    with ThreadPoolExecutor(max(1, args.workers)) as ex:
        all_sizes = list(ex.map(job, annotations))
    np.savez(os.path.join(args.out_root, "scannet_means.npz"),
             arr_0=mean_sizes_array(all_sizes))

    if args.splits_out and args.scannet_splits:
        build_splits(args.out_root, args.splits_out, args.scannet_splits)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
