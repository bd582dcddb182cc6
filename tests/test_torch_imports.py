"""Boundaries of the port: no JAX, flax, optax, orbax, YAML package,
matplotlib or `rfdnet_tpu` inside it (every module of the package, scanned),
its settings equal the test config's, and its entry points never drop to
the CPU on their own.

The import check reads the source (AST) rather than `sys.modules`, because
JAX may already be imported when the interpreter starts.
"""

import ast
import os

import numpy as np
import pytest
import torch

from rfdnet_tpu.config.config import Config
from rfdnet_tpu.config.scannet import ScannetConfig
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch import demo
from rfdnet_tpu_torch.prep import scannet as prep_scannet
from rfdnet_tpu_torch.prep import shapenet as prep_shapenet
from rfdnet_tpu_torch.tools import profile_train, protocol_run, sanity_train
from torch_parity import TEST_YAML

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "yaml", "matplotlib",
             "rfdnet_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "rfdnet_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the multi-rank tests' rank workers run in processes without JAX
    yield os.path.join(ROOT, "tests", "torch_dist.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_config_equals_test_yaml():
    cfg = Config(TEST_YAML, mode="test", make_dirs=False).config
    for section, values in tconfig.TEST_CONFIG.items():
        for key, value in values.items():
            assert cfg[section][key] == value, (section, key)
    ec = Config(TEST_YAML, mode="test", make_dirs=False).eval_config
    assert tconfig.eval_config() == {
        k: ec[k] for k in ("nms_iou", "cls_nms", "remove_empty_box",
                           "per_class_proposal", "conf_thresh")}


def test_dataset_constants_equal_rfdnet_tpu():
    dc = ScannetConfig()
    assert (tconfig.NUM_CLASS, tconfig.NUM_HEADING_BIN,
            tconfig.NUM_SIZE_CLUSTER) == (dc.num_class, dc.num_heading_bin,
                                          dc.num_size_cluster)
    np.testing.assert_array_equal(tconfig.MEAN_SIZE_ARR, dc.mean_size_arr)


def test_entry_points_without_device_or_cuda_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconfig.build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.load_demo_data(os.path.join(
            ROOT, "demo", "outputs", "synthetic_room", "synthetic_room.off"),
            num_points=16)
    # the offline preparation's two entry points, before they read a file
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prep_shapenet.main(["--in_root", str(tmp_path), "--out_root",
                            str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prep_scannet.main([
            "--scan2cad", str(tmp_path / "absent.json"), "--scans_root",
            str(tmp_path), "--shapenet_root", str(tmp_path), "--label_tsv",
            str(tmp_path / "absent.tsv"), "--out_root", str(tmp_path)])
    # the learning check and the train-step profile, before any work
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sanity_train.main(["--save-to", str(tmp_path / "weights")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train.main(["--trace", str(tmp_path / "trace.json")])
    # the protocol run, before it reads the dataset or writes a config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol_run.main(["--root", str(tmp_path / "ds"), "--out",
                           str(tmp_path / "out")])
    assert os.listdir(tmp_path) == []
