"""The port's ScanNet + Scan2CAD preparation (`rfdnet_tpu_torch.prep.
scannet`, at `device='cpu'`) against the JAX package's tool
(`tools/prep/scannet.py`) on a tiny raw scene written with numpy by
`data.synthetic.write_raw_scan2cad_scene` (a binary PLY scan, its
aggregation, segments and meta files, three CAD `.obj` models, a Scan2CAD
annotation), and two utilities (`write_ply_rgb`, `clean_log_dirs`).

Tolerances: the geometry helpers are the same float64 numpy code on both
sides, so their results are equal; the box membership of the votes is a
torch product on the port's side and a numpy one on the tool's, which may
round the box coordinates differently in the last place, so a point
within ~1e-15 of the box's 1e-9 margin could differ: none of this
scene's points is (the votes, and so `full_scan.npz`, are equal).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from rfdnet_tpu.utils import logging as jlogging
from rfdnet_tpu.utils import visualization as jviz
from rfdnet_tpu_torch.data.synthetic import (
    RAW_SCENE,
    write_raw_scan2cad_scene,
)
from rfdnet_tpu_torch.meshing.mesh import read_ply
from rfdnet_tpu_torch.prep import scannet as tscannet
from rfdnet_tpu_torch.utils import logging as tlogging
from rfdnet_tpu_torch.utils import visualization as tviz
from tools.prep import scannet as jscannet

SCENE = RAW_SCENE


def _raw_scene(root):
    """The raw files of one scene (a chair, a table and an airplane, which
    is no detection class); returns (annotation, paths)."""
    return write_raw_scan2cad_scene(str(root))


def test_geometry_helpers_equal():
    rng = np.random.RandomState(0)
    for _ in range(5):
        q = rng.randn(4)
        np.testing.assert_array_equal(tscannet.quaternion_matrix(q),
                                      jscannet.quaternion_matrix(q))
        t, s = rng.randn(3), rng.uniform(0.5, 2, 3)
        np.testing.assert_array_equal(tscannet.make_M_from_tqs(t, q, s),
                                      jscannet.make_M_from_tqs(t, q, s))
    np.testing.assert_array_equal(tscannet.quaternion_matrix([0, 0, 0, 0]),
                                  np.eye(3))
    for _ in range(10):
        boxes = []
        for _ in range(2):
            o = rng.uniform(-np.pi, np.pi)
            axis = np.array([[np.cos(o), np.sin(o), 0],
                             [-np.sin(o), np.cos(o), 0], [0, 0, 1]])
            vec = np.diag(rng.uniform(0.2, 1.0, 3)) @ axis
            boxes.append(jscannet.get_box_corners(rng.uniform(-0.3, 0.3, 3),
                                                  vec))
        center, vec = rng.randn(3), rng.randn(3, 3)
        np.testing.assert_array_equal(
            tscannet.get_box_corners(center, vec),
            jscannet.get_box_corners(center, vec))
        got = tscannet.get_iou_cuboid(*boxes)
        assert got == jscannet.get_iou_cuboid(*boxes)
        assert 0 <= got <= 1


def test_points_in_obb_and_votes_equal():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1.5, 1.5, (4000, 3))
    votes_j, idx_j = np.zeros((len(pts), 10)), np.zeros(len(pts), np.int32)
    votes_t = torch.zeros((len(pts), 10), dtype=torch.float64)
    idx_t = torch.zeros(len(pts), dtype=torch.int32)
    # four overlapping boxes, so that points take a first, second and third
    # vote and a fourth that overwrites the third
    for k in range(4):
        box = np.array([0.1 * k, -0.05 * k, 0.0, 1.6, 1.2, 1.4, 0.3 * k])
        o = box[6]
        axis = np.array([[np.cos(o), np.sin(o), 0],
                         [-np.sin(o), np.cos(o), 0], [0, 0, 1]])
        corners = jscannet.get_box_corners(box[:3],
                                           np.diag(box[3:6] / 2) @ axis)
        np.testing.assert_array_equal(
            tscannet.points_in_obb(torch.from_numpy(pts), corners).numpy(),
            jscannet.points_in_obb(pts, corners))
        jscannet.accumulate_votes(box, pts, votes_j, idx_j)
        tscannet.accumulate_votes(box, torch.from_numpy(pts), votes_t, idx_t)
    np.testing.assert_array_equal(votes_t.numpy(), votes_j)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    assert (idx_j == 2).sum() > 100 and (idx_j == 1).sum() > 10


def _read_scene(out_root):
    with open(os.path.join(out_root, SCENE, "bbox.pkl"), "rb") as f:
        boxes = pickle.load(f)
    scan = np.load(os.path.join(out_root, SCENE, "full_scan.npz"))
    return boxes, {k: scan[k] for k in scan.files}


def test_generate_scene_and_splits_equal(tmp_path):
    annotation, paths = _raw_scene(tmp_path)
    label_map = jscannet.read_label_map(paths["tsv"])
    assert tscannet.read_label_map(paths["tsv"]) == label_map
    out = {}
    for side, mod, kw in (("jax", jscannet, {}),
                          ("torch", tscannet, {"device": "cpu"})):
        root = str(tmp_path / side / "out")
        sizes = mod.generate_scene(annotation, paths["scans"],
                                   paths["shapenet"], label_map, root, **kw)
        mod.build_splits(root, str(tmp_path / side / "splits"),
                         paths["splits"])
        out[side] = (sizes, *_read_scene(root))
        # done before: nothing is written again
        assert mod.generate_scene(annotation, paths["scans"],
                                  paths["shapenet"], label_map, root,
                                  **kw) is None
    (j_sizes, j_boxes, j_scan), (t_sizes, t_boxes, t_scan) = (
        out["jax"], out["torch"])
    assert sorted(t_sizes) == sorted(j_sizes)
    for c in j_sizes:
        np.testing.assert_array_equal(np.array(t_sizes[c]),
                                      np.array(j_sizes[c]))
    assert len(t_boxes) == len(j_boxes) == 2
    assert [b["cls_id"] for b in t_boxes] == [7, 1]
    assert [b["instance_id"] for b in t_boxes] == [1, 2]
    for tb, jb in zip(t_boxes, j_boxes):
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert sorted(t_scan) == sorted(j_scan)
    for k in j_scan:
        np.testing.assert_array_equal(t_scan[k], j_scan[k], err_msg=k)
        assert t_scan[k].dtype == j_scan[k].dtype
    assert j_scan["point_votes"][:, 0].sum() > 500
    for split in ("train", "val"):
        name = f"scannetv2_{split}.json"
        with open(tmp_path / "torch" / "splits" / name) as f:
            got = json.load(f)
        with open(tmp_path / "jax" / "splits" / name) as f:
            assert got == json.load(f)
        assert len(got) == (split == "train")


def test_cli_on_cpu(tmp_path):
    """`python -m rfdnet_tpu_torch.prep.scannet --device cpu`: the scene's
    files, the class means of its sizes (the JAX tool's sum), the splits."""
    annotation, paths = _raw_scene(tmp_path)
    out_root = tmp_path / "out"
    assert tscannet.main([
        "--scan2cad", str(tmp_path / "scan2cad.json"), "--scans_root",
        paths["scans"], "--shapenet_root", paths["shapenet"], "--label_tsv",
        paths["tsv"], "--out_root", str(out_root), "--splits_out",
        str(tmp_path / "split_json"), "--scannet_splits", paths["splits"],
        "--workers", "2", "--device", "cpu"]) == 0
    sizes = jscannet.generate_scene(
        annotation, paths["scans"], paths["shapenet"],
        jscannet.read_label_map(paths["tsv"]), str(tmp_path / "jax"))
    want = np.zeros((len(jscannet.OBJ_CLASS_IDS), 3))
    for i, c in enumerate(jscannet.OBJ_CLASS_IDS):
        if sizes[int(c)]:
            want[i] = np.mean(sizes[int(c)], axis=0)
    np.testing.assert_array_equal(
        np.load(out_root / "scannet_means.npz")["arr_0"], want)
    assert (want != 0).any(axis=1).sum() == 2
    boxes, scan = _read_scene(str(out_root))
    assert len(boxes) == 2 and scan["point_votes"].shape[1] == 10
    with open(tmp_path / "split_json" / "scannetv2_train.json") as f:
        entry = json.load(f)[0]
    assert os.path.exists(tmp_path / "split_json" / entry["scan"])


def _cli(tmp_path, paths, out_root):
    return tscannet.main([
        "--scan2cad", str(tmp_path / "scan2cad.json"), "--scans_root",
        paths["scans"], "--shapenet_root", paths["shapenet"], "--label_tsv",
        paths["tsv"], "--out_root", str(out_root), "--workers", "2",
        "--device", "cpu"])


def test_cli_bad_scenes_and_device_errors(tmp_path, monkeypatch, capsys):
    """A scene without its files is reported and skipped, the others are
    written and the run returns 1; an error of the device (as a CUDA
    failure raises) ends the run."""
    annotation, paths = _raw_scene(tmp_path)
    missing = dict(annotation, id_scan="scene0009_00")
    with open(tmp_path / "scan2cad.json", "w") as f:
        json.dump([missing, annotation], f)
    assert _cli(tmp_path, paths, tmp_path / "out") == 1
    assert "FAILED scene0009_00:" in capsys.readouterr().out
    boxes, _ = _read_scene(str(tmp_path / "out"))
    assert len(boxes) == 2

    def broken(*args):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tscannet, "accumulate_votes", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _cli(tmp_path, paths, tmp_path / "out2")


@pytest.mark.parametrize("colors", ["uint8", "float"])
def test_write_ply_rgb_read_back(tmp_path, colors):
    rng = np.random.RandomState(2)
    pts = rng.randn(500, 3).astype(np.float32)
    rgb = (rng.randint(0, 256, (500, 3)).astype(np.uint8) if colors == "uint8"
           else rng.uniform(-0.2, 1.2, (500, 3)))
    tviz.write_ply_rgb(str(tmp_path / "t.ply"), pts, rgb)
    jviz.write_ply_rgb(str(tmp_path / "j.ply"), pts, rgb)
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())
    got = tscannet.read_mesh_vertices_rgb(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(got[:, :3], pts)
    want_rgb = (rgb if colors == "uint8"
                else (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(got[:, 3:], want_rgb)
    verts, faces = read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(verts, pts)
    assert len(faces) == 0


def test_clean_log_dirs(tmp_path):
    """A run directory stays when it holds one of the port's checkpoints
    (`model_last.npz`, `model_best.npz`) or the JAX package's
    (`model_last/`, `model_best/`); the others go, as in the JAX package."""
    keep = {"port_last": "model_last.npz", "port_best": "model_best.npz",
            "jax_last": "model_last", "jax_best": "model_best"}
    drop = {"empty": None, "log_only": "log.txt", "opt_only": "model_last.opt"}
    for run, marker in {**keep, **drop}.items():
        os.makedirs(tmp_path / run)
        if marker in ("model_last", "model_best"):
            os.makedirs(tmp_path / run / marker)
        elif marker:
            (tmp_path / run / marker).write_text("x")
    (tmp_path / "stray.txt").write_text("not a run")
    removed = tlogging.clean_log_dirs(str(tmp_path))
    assert sorted(os.path.basename(p) for p in removed) == sorted(drop)
    assert sorted(os.listdir(tmp_path)) == sorted([*keep, "stray.txt"])
    assert tlogging.clean_log_dirs(str(tmp_path / "absent")) == []
    # the JAX package's version keeps only its own checkpoint names
    assert sorted(os.path.basename(p) for p in jlogging.clean_log_dirs(
        str(tmp_path))) == ["port_best", "port_last"]
