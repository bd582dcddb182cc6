"""`rfdnet_tpu_torch.tools.gen_synthetic_dataset` against the JAX tool
`tools/gen_synthetic_dataset.py`, on the CPU: at one seed both write the
same files (arrays equal, binvox / OFF / split files byte-equal, pickles
equal by content); and the port's counterparts of
`tests/test_heading_labels.py`'s generator checks, through the port's
`ScanNetDataset` and its flip augmentation: the heading labels of raw and
augmented scenes describe their points, every class is mirror-symmetric
about its own y axis, and a flip's label update keeps a shape's points
inside it.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from rfdnet_tpu_torch.config import MEAN_SIZE_ARR, NUM_HEADING_BIN
from rfdnet_tpu_torch.data.scannet import ScanNetDataset
from rfdnet_tpu_torch.ops.boxes import class2angle
from rfdnet_tpu_torch.tools import gen_synthetic_dataset as gen
from tools import gen_synthetic_dataset as jax_gen

ARGS = ["--train", "2", "--val", "1", "--points", "5000", "--variants", "1"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX tool's and the port's datasets at one seed."""
    root = tmp_path_factory.mktemp("gen")
    jax_gen.main(["--out", str(root / "jax"), *ARGS])
    gen.main(["--out", str(root / "port"), *ARGS])
    return str(root / "jax"), str(root / "port")


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_file_list(both):
    want = _files(both[0])
    assert _files(both[1]) == want
    # 8 classes x 1 variant x 3 assets, 3 scenes x 2 files, 2 + 2 splits
    assert len(want) == 8 * 3 + 3 * 2 + 4


def test_npz_arrays_equal(both):
    """Occupancy points (f16 points, packed bits) and scans
    (`mesh_vertices`, `point_votes`, `instance_labels`), array by array
    (np.savez writes zip timestamps, so not byte by byte)."""
    names = [f for f in _files(both[0]) if f.endswith(".npz")]
    assert len(names) == 8 + 3
    for name in names:
        with np.load(os.path.join(both[0], name)) as a, \
                np.load(os.path.join(both[1], name)) as b:
            assert a.files == b.files, name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{name} {k}")


@pytest.mark.parametrize("suffix", [".binvox", ".off", ".json", ".txt"])
def test_files_byte_equal(both, suffix):
    names = [f for f in _files(both[0]) if f.endswith(suffix)]
    assert names
    for name in names:
        with open(os.path.join(both[0], name), "rb") as a, \
                open(os.path.join(both[1], name), "rb") as b:
            assert a.read() == b.read(), name


def test_bbox_pickles_equal(both):
    names = [f for f in _files(both[0]) if f.endswith("bbox.pkl")]
    assert len(names) == 3
    for name in names:
        with open(os.path.join(both[0], name), "rb") as a, \
                open(os.path.join(both[1], name), "rb") as b:
            want, got = pickle.load(a), pickle.load(b)
        assert len(got) == len(want) >= 4
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["box3D"].dtype == w["box3D"].dtype == np.float64
            np.testing.assert_array_equal(g["box3D"], w["box3D"])
            assert type(g["cls_id"]) is type(w["cls_id"]) is int
            for k in ("cls_id", "shapenet_catid", "shapenet_id",
                      "instance_id"):
                assert g[k] == w[k], (name, k)


def test_class_tables_match_jax_tool():
    """`CLASS_IND` / `SHAPENET_CLS_ID`, which the JAX tool fills in its
    `main`, from the port's config at import."""
    from rfdnet_tpu.config.scannet import SHAPENETCLASSES, ScannetConfig

    dc = ScannetConfig()
    assert gen.CATIDS == jax_gen.CATIDS
    for catid, name in jax_gen.CATIDS.items():
        assert gen.SHAPENET_CLS_ID[catid] == SHAPENETCLASSES.index(name)
        assert gen.CLASS_IND[catid] == dc.shapenetid2class[
            SHAPENETCLASSES.index(name)]
    assert sorted(gen.CLASS_IND.values()) == list(range(8))


# ----------------------------------------------- heading supervision


@pytest.fixture(scope="module")
def tiny_ds(tmp_path_factory):
    """Two train scenes and one val scene from the port's generator, at
    `test_heading_labels.py`'s seed and size."""
    root = tmp_path_factory.mktemp("heading_ds")
    gen.main(["--out", str(root), "--train", "2", "--val", "1",
              "--points", "20000", "--variants", "2", "--seed", "7"])
    return str(root)


def _check_points_in_labeled_boxes(pc, inst, boxes3D, inst_ids, tol=0.08):
    """Each instance's points, de-rotated by the labeled heading about the
    labeled center, fit the labeled size box (plus the sensor noise)."""
    checked = 0
    for k, box in zip(inst_ids, boxes3D):
        pts = pc[inst == k, :3]
        if len(pts) < 10:
            continue
        center, size, heading = box[0:3], box[3:6], box[6]
        c, s = np.cos(-heading), np.sin(-heading)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        local = (pts - center) @ R.T
        assert np.all(np.abs(local) <= size / 2 + tol), (
            f"instance {k}: de-rotated points exceed the labeled box "
            f"(max {np.abs(local).max(0)}, half-size {size / 2})")
        checked += 1
    return checked


def test_raw_scene_heading_consistent(tiny_ds):
    base = os.path.join(tiny_ds, "splits")
    with open(os.path.join(base, "scannetv2_train.json")) as f:
        split = json.load(f)
    assert len(split) == 2
    for entry in split:
        with np.load(os.path.join(base, entry["scan"])) as scan, \
                open(os.path.join(base, entry["bbox"]), "rb") as f:
            info = pickle.load(f)
            boxes = np.array([it["box3D"] for it in info])
            ids = [it["instance_id"] for it in info]
            n = _check_points_in_labeled_boxes(
                scan["mesh_vertices"], scan["instance_labels"], boxes, ids)
        assert n >= 3  # scenes carry >= 4 objects


def test_augmented_scene_heading_consistent(tiny_ds):
    """After the port's flips and z-rotation the updated heading labels
    still describe the augmented points, over enough epochs that both
    flips and assorted rotations occur."""
    ds = ScanNetDataset(
        os.path.join(tiny_ds, "splits", "scannetv2_train.json"),
        mode="train", phase="detection", num_points=16384, seed=3)
    assert ds.augment
    checked = 0
    for epoch in range(6):
        ds.set_epoch(epoch)
        for idx in range(len(ds)):
            item = ds[idx]
            pc = item["point_clouds"]
            mask = item["box_label_mask"].astype(bool)
            heading = class2angle(
                torch.from_numpy(item["heading_class_label"][mask]
                                 .astype(np.int64)),
                torch.from_numpy(item["heading_residual_label"][mask]
                                 .astype(np.float64)),
                NUM_HEADING_BIN).numpy()
            boxes = np.concatenate([
                item["center_label"][mask],
                MEAN_SIZE_ARR[item["size_class_label"][mask].astype(int)]
                + item["size_residual_label"][mask],
                heading[:, None],
            ], axis=1)
            # a point's vote leads to its object's center
            votes = item["vote_label"][:, :3]
            vmask = item["vote_label_mask"].astype(bool)
            tgt = pc[vmask, :3] + votes[vmask]
            d = np.linalg.norm(tgt[:, None, :] - boxes[None, :, 0:3], axis=-1)
            inst = d.argmin(1)
            near = d.min(1) < 1e-3  # exact vote targets only
            checked += _check_points_in_labeled_boxes(
                pc[vmask][near], inst[near], boxes, list(range(len(boxes))))
    assert checked >= 20


def test_canonical_shapes_y_mirror_symmetric():
    """The flip's heading updates (x-flip: pi - theta, y-flip: -theta)
    keep labels consistent with the points only for shapes that are
    mirror-symmetric about their own y axis: every class, every draw."""
    rng = np.random.RandomState(0)
    q = rng.uniform(-0.5, 0.5, (20000, 3))
    q_m = q * np.array([1.0, -1.0, 1.0])
    for name in gen.CATIDS.values():
        for _ in range(4):
            occ = gen.make_shape(name, rng)
            np.testing.assert_array_equal(
                occ(q), occ(q_m),
                err_msg=f"{name}: canonical shape not y-mirror-symmetric")


def test_flip_label_update_shape_consistent():
    """Flip a placed shape's world points, update the heading by the
    reference's rule and de-rotate by the new label: as many points fall
    inside the shape as without the flip."""
    rng = np.random.RandomState(1)
    for name in ("chair", "sofa", "bookshelf", "cabinet"):
        occ = gen.make_shape(name, rng)
        verts, tris = gen.shape_mesh(occ)
        pts = gen.sample_surface(verts, tris, 3000, rng)

        def frac_inside(points, label):
            c, s = np.cos(-label), np.sin(-label)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            return occ(np.clip(points @ R.T, -0.5, 0.5)).mean()

        theta = 0.7
        c, s = np.cos(theta), np.sin(theta)
        world = pts @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
        base = frac_inside(world, theta)
        fx = frac_inside(world * [-1, 1, 1], np.sign(theta) * np.pi - theta)
        fy = frac_inside(world * [1, -1, 1], -theta)
        assert fx >= base - 1e-6, (name, base, fx)
        assert fy >= base - 1e-6, (name, base, fy)
