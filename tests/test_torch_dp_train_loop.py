"""The CLI's train mode over 2 gloo ranks on the CPU (`cli.rank_summary`,
which `cli.run_train_ranks` starts a card each on the GPU machine),
beside the same run in one process: two scenes at 2048 points, the
widths of SMALL, one epoch at batch 2 (one train and one val step).

Each rank's loader reads its scene of the global batch and the step's
loss terms are the global batch's, so rank 0's logged train terms equal
the one-process run's within `tests/test_train.py`'s 1e-3; the ranks end
with the same parameters (their bytes' digests equal), which rank 0's
checkpoint holds within Adam's bound of 2 x lr of the one-process run's;
only rank 0 writes the run directory (checkpoints, log board,
visualizations).
"""

import json
import os
import sys

import pytest

from rfdnet_tpu_torch import cli, weights
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes
from torch_parity import ROOT, SMALL
import torch_dist


def _config(paths, log_path):
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "iscnet.yaml"),
                              mode="train")
    tconfig.update_recursive(cfg, {
        "finetune": False, "weight": [], "seed": 0,
        "device": {"num_workers": 1},
        "data": {**SMALL["data"], "num_point": 2048,
                 "split": paths["split"],
                 "shapenet_path": paths["shapenet_path"]},
        "train": {"epochs": 1, "batch_size": 2},
        "val": {"batch_size": 2},
        "log": {"path": log_path, "vis_step": 1, "print_step": 1}})
    return cfg


def _scalars(run_dir, phase):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == phase]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    root = tmp_path_factory.mktemp("dp_loop")
    paths = write_scannet_scenes(str(root / "data"), 2, num_points=2048)
    monkeypatch_module.chdir(root)
    monkeypatch_module.setitem(sys.modules, "torch.utils.tensorboard", None)
    ranks = torch_dist.start(torch_dist.train_rank, 2,
                             _config(paths, str(root / "ranks")))
    one = cli.run_train(_config(paths, str(root / "one")), device="cpu")
    return root, one, ranks.result()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_rank0_alone_writes_the_run(runs):
    root, _, ranks = runs
    assert ranks[1]["save_path"] is None
    assert os.listdir(root / "ranks") == [os.path.basename(
        ranks[0]["save_path"])]
    files = os.listdir(ranks[0]["save_path"])
    for name in ("model_best.npz", "model_last.npz", "log.txt",
                 "scalars.jsonl", "visualization"):
        assert name in files, name
    for r in ranks:
        assert [(s["epoch"], s["phase"]) for s in r["step_times"]] == [
            (0, "train"), (0, "val")]


def test_ranks_match_one_process(runs):
    _, one, ranks = runs
    want = _scalars(one.save_path, "train")[-1]
    got = _scalars(ranks[0]["save_path"], "train")[-1]
    assert set(got) == set(want)
    for k, v in want.items():
        if k not in ("phase", "step", "time"):
            assert abs(got[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, got[k], v)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    # rank 0's checkpoint: the parameters every rank holds
    model = tconfig.build_model(one.cfg, device="cpu", mode="train")
    report = []
    weights.load_npz(model, os.path.join(ranks[0]["save_path"],
                                         "model_last.npz"), log=report.append)
    assert report[0] == "set() subnet missed."
    lr = float(one.cfg["optimizer"]["lr"])
    theirs = dict(model.named_parameters())
    for name, p in one.model.named_parameters():
        assert (theirs[name] - p).abs().max() <= 2 * lr * 1.001 + 1e-7, name
