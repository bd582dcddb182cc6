"""The port's Tester against `rfdnet_tpu`'s on the CPU: `Tester.run` on an
on-disk dataset against the JAX Tester, the CLI's test mode with its dumps
(`scene.html` among them) and its refusals, and the grid downloads.
Split from `tests/test_torch_tester.py` (same names), so that xdist's
`--dist loadfile` runs the two halves on two workers.

Tolerances: `Tester.run`'s metrics (mAP, AR, per-class AP and recall,
voxel IoU) are equal to 1e-6; the dumps of a serial run equal the first
run's bytes.
"""

import os

import numpy as np
import pytest
import torch

from rfdnet_tpu.cli import _build_loaders as jbuild_loaders
from rfdnet_tpu.config.config import Config
from rfdnet_tpu.eval import tester as jtester
from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes
from rfdnet_tpu_torch.eval import tester
from rfdnet_tpu_torch.meshing.generator import Generator3D
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from test_torch_tester import LOW, TINY
from torch_parity import TEST_YAML, assert_equal, iscnet_pair


@pytest.fixture(scope="module")
def pair():
    return iscnet_pair(generate_limit=8)


# ----------------------------------------------------------- the Tester
@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    return write_scannet_scenes(str(tmp_path_factory.mktemp("scannet")), 2,
                                seed=2, num_points=5000, num_objects=4)


def _configs(on_disk, overrides):
    jcfg = Config(TEST_YAML, mode="test", make_dirs=False)
    cfg = tconfig.load_config(TEST_YAML, mode="test")
    for c in (jcfg.config, cfg):
        tconfig.update_recursive(c, TINY)
        tconfig.update_recursive(c, {"data": dict(on_disk)})
        tconfig.update_recursive(c, overrides)
    assert cfg == jcfg.config
    return jcfg, cfg


def test_tester_run_matches_jax(pair, on_disk):
    """Both Testers over the same two on-disk scenes, completion phase
    without meshes (so no grids and no refit), AP at 0.25."""
    model, variables, port = pair
    jcfg, cfg = _configs(on_disk, {
        "generation": {"generate_mesh": False},
        "test": {"ap_iou_thresholds": [0.25]}})
    thresholds = cfg["test"]["ap_iou_thresholds"]
    want = jtester.Tester(jcfg, model, variables, jcfg.dataset_config,
                   log=lambda m: None).run(
        jbuild_loaders(jcfg, ["test"])["test"], ap_iou_thresholds=thresholds)
    ours = tester.Tester(cfg, port, log=lambda m: None)
    got = ours.run(cli._build_loaders(cfg, ["test"])["test"],
                     ap_iou_thresholds=thresholds)
    assert sorted(got) == sorted(want)
    assert any(k.endswith("voxel IoU") for k in got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert len(ours.scene_ms) == 2
    assert sorted(ours.scene_ms[0]) == ["ap", "d2h", "dispatch", "mesh",
                                        "refit"]
    assert ours.metrics_ms > 0


@pytest.fixture(scope="module")
def small_yaml(on_disk, tmp_path_factory):
    """A copy of the test config at a CPU size: 2048 points, 6^3 grids,
    meshes, refit and dumps on."""
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    text = open(TEST_YAML).read()
    for old, new in (("num_point: 80000", "num_point: 2048"),
                     ("resolution_0: 32", "resolution_0: 6"),
                     ("dump_threshold: 0.5", f"dump_threshold: {LOW}"),
                     ("split: datasets/splits/fullscan",
                      f"split: {on_disk['split']}"),
                     ("shapenet_path: datasets/ShapeNetv2_data",
                      f"shapenet_path: {on_disk['shapenet_path']}"),
                     ("\nseed: 10\n", "\nseed: 0\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


def _small_model(monkeypatch):
    """The CLI's model with 8 generated slots (the CPU's size)."""
    build = tconfig.build_model
    monkeypatch.setattr(cli, "build_model", lambda cfg, device=None: build(
        cfg, generate_limit=8, device=device))


def _read_dumps(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_cli_test_mode_on_cpu(small_yaml, tmp_path, monkeypatch, capsys):
    """`--mode test --device cpu`: the AP table printed, the dumps of both
    scenes written (refit boxes, placed meshes); a serial run (no scene in
    flight) gives the same metrics and files."""
    _small_model(monkeypatch)
    monkeypatch.chdir(tmp_path)
    metrics = cli.main(["--config", small_yaml, "--mode", "test",
                        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mode: test" in printed and "----- AP @ IoU 0.5 -----" in printed
    assert "mAP" in printed and "voxel IoU" in printed
    assert "export failed" not in printed
    assert "mAP @0.5" in metrics and "AR @0.5" in metrics
    root = tmp_path / "out" / "test" / "visualization"
    assert sorted(os.listdir(root)) == ["scene_00000", "scene_00001"]
    files = sorted(os.listdir(root / "scene_00000"))
    for name in ("000000_pc.ply", "000000_pred_confident_nms_bbox.ply",
                 "gt_map_cls.txt", "pred_map_cls.txt", "scene.html"):
        assert name in files
    meshes = [f for f in files if f.startswith("proposal_")]
    assert 0 < len(meshes) <= 8
    for f in meshes:
        mesh = TriMesh.load(str(root / "scene_00000" / f))
        assert len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()
    scan = TriMesh.load(str(root / "scene_00000" / "000000_pc.ply"))
    assert scan.vertices.shape == (2048, 3)
    gt_lines = open(root / "scene_00000" / "gt_map_cls.txt").read().split("\n")
    assert len([ln for ln in gt_lines if ln]) == 4
    pred_lines = (root / "scene_00000" / "pred_map_cls.txt").read_text()
    assert len(pred_lines.split("\n")[0].split()) == 2 + 24
    dumps = _read_dumps(root)

    os.rename(root, tmp_path / "first")
    cfg = tconfig.load_config(small_yaml, mode="test")
    serial, serial_tester = cli.run_test(cfg, device="cpu", overlap=False,
                                         log=lambda m: None)
    assert serial == metrics
    assert _read_dumps(root) == dumps
    assert all(ms["refit"] > 0 and "dump" in ms
               for ms in serial_tester.scene_ms)


def test_cli_test_mode_refusals(small_yaml, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", small_yaml, "--mode", "test"])
    # the mesh mAP, once refused, now turns on and dumps at conf_thresh
    cfg = tconfig.load_config(small_yaml, mode="test")
    cfg["test"]["evaluate_mesh_mAP"] = True
    on = tester.Tester(cfg, tconfig.build_model(cfg, generate_limit=2,
                                                device="cpu"))
    assert on.evaluate_mesh_mAP
    assert on.dump_threshold == on.eval_config["conf_thresh"]


def test_grid_downloads_keep_their_own_buffers():
    """Two downloads outstanding at once: each keeps its own grids, also
    after the device tensors are overwritten."""
    gen = Generator3D(None, resolution0=4)
    a = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 4, 4, 4)
    b = -a
    first, second = gen.start_download(a), gen.start_download(b)
    want_a, want_b = a.numpy().copy(), b.numpy().copy()
    a.fill_(7.0)
    b.fill_(9.0)
    got_a, got_b = first.wait(), second.wait()
    assert not np.shares_memory(got_a, got_b)
    assert_equal(got_a, want_a)
    assert_equal(got_b, want_b)
