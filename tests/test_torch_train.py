"""The training path of the port against `rfdnet_tpu`'s, on the CPU.

Covered here: train-mode batch norms, `nn_distance`, every term of the
detection loss, the plateau and BN-momentum schedules, the dataset's
train-mode items and the loader's order, checkpoints, and the CLI's train
mode followed by its test mode on the checkpoint it wrote. The backward of
each module in train mode is `test_torch_train_grads.py`, and one train step
of each stage against `rfdnet_tpu.train.trainer.make_train_step` is
`test_torch_train_step_stage{1,2,3}.py` (a file each, so that xdist's
`--dist loadfile` spreads their JAX compiles over workers; shared set-up
and the step check in `torch_parity`).

Inputs are made with numpy from a seed; the flax variables come from
`model.init` plus seeded noise and reach the port through
`weights.from_flax` (`torch_parity`).

Tolerances: index outputs (FPS indices, selected proposals with their GT
ids and classes, nearest-neighbour indices) are exact; losses use f32's
atol 3e-5, rtol 2e-4 (`tests/test_parity_torch.py:41-42`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rfdnet_tpu.config.config import Config, update_recursive
from rfdnet_tpu.config.scannet import ScannetConfig
from rfdnet_tpu.data import scannet as jscannet
from rfdnet_tpu.data.synthetic import synthetic_scene_batch
from rfdnet_tpu.models import common as jcommon
from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu.models import losses as jlosses
from rfdnet_tpu.models.iscnet import select_completion_proposals as jselect
from rfdnet_tpu.ops.nn_distance import huber_loss as jhuber
from rfdnet_tpu.ops.nn_distance import nn_distance as jnn_distance
from rfdnet_tpu.train import trainer as jtrainer
from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data import scannet as tscannet
from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes
from rfdnet_tpu_torch.models import common as tcommon
from rfdnet_tpu_torch.models import layers as tlayers
from rfdnet_tpu_torch.models import losses as tlosses
from rfdnet_tpu_torch.models.iscnet import select_completion_proposals
from rfdnet_tpu_torch.ops import nn_distance as tnn
from rfdnet_tpu_torch.train import checkpoint as tcheckpoint
from rfdnet_tpu_torch.train import trainer as ttrainer
from rfdnet_tpu_torch.train.loop import Trainer
from rfdnet_tpu_torch.weights import flax_flat, from_flax, init_seeded
from torch_parity import (SMALL, assert_close, assert_equal, perturb,
                          step_variables, t, torch_batch, train_configs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
@pytest.mark.parametrize("kind", ["BatchNorm", "_AffinelessBatchNorm"])
def test_batch_norm_train_mode(kind):
    """Outputs and running statistics of one train-mode call with momentum
    0.5, on 3-D and 4-D inputs."""
    rng = np.random.RandomState(0)
    for shape in ((2, 300, 16), (2, 64, 8, 16)):
        x = (0.5 + rng.randn(*shape)).astype(np.float32)
        if kind == "BatchNorm":
            jm, tm = jcommon.BatchNorm(), tcommon.BatchNorm(16)
        else:
            jm, tm = jlayers._AffinelessBatchNorm(), tlayers._AffinelessBatchNorm(16)
        v = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 1)
        want, upd = jm.apply(v, jnp.asarray(x), True, 0.5,
                             mutable=["batch_stats"])
        tm.load_state_dict(from_flax({"params": {}, **v}))
        tm.momentum = 0.5
        tm.train()
        with torch.no_grad():
            got = tm(t(x))
        assert_close(got, want)
        assert_close(tm.running_mean, upd["batch_stats"]["mean"])
        assert_close(tm.running_var, upd["batch_stats"]["var"])
        tm.eval()
        with torch.no_grad():
            got_eval = tm(t(x))
        want_eval = jm.apply({**v, **upd}, jnp.asarray(x), False)
        assert_close(got_eval, want_eval)


def test_set_bn_momentum_reaches_every_batch_norm():
    model = tconfig.build_model(tconfig.load_config(
        os.path.join(ROOT, "configs", "iscnet.yaml"), mode="train"),
        device="cpu", mode="train")
    tcommon.set_bn_momentum(model, 0.25)
    norms = [m for m in model.modules()
             if isinstance(m, (tcommon.BatchNorm, tlayers._AffinelessBatchNorm))]
    assert len(norms) > 50 and all(m.momentum == 0.25 for m in norms)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("mode", ["l2", "l1", "l1smooth"])
def test_nn_distance(mode):
    rng = np.random.RandomState(2)
    a = rng.randn(2, 50, 3).astype(np.float32)
    b = rng.randn(2, 20, 3).astype(np.float32)
    b[:, 5] = b[:, 4]  # a tie: the first index wins
    kw = {"l1": mode == "l1", "l1smooth": mode == "l1smooth"}
    want = jnn_distance(jnp.asarray(a), jnp.asarray(b), **kw)
    got = tnn.nn_distance(t(a), t(b), **kw)
    for g, w, name in zip(got, want, ("dist1", "idx1", "dist2", "idx2")):
        if name.startswith("idx"):
            assert_equal(g, w, what=name)
        else:
            assert_close(g, w, what=name)
    err = rng.randn(100).astype(np.float32) * 2
    assert_close(tnn.huber_loss(t(err), 1.0), jhuber(jnp.asarray(err), 1.0))


def _detection_inputs(seed: int):
    """Random end points of 32 proposals around a synthetic batch's
    objects, and the batch."""
    rng = np.random.RandomState(seed)
    gt = synthetic_scene_batch(rng, batch_size=2, num_points=512,
                               mean_size_arr=tconfig.MEAN_SIZE_ARR)
    K, S = 32, 128
    obj = gt["center_label"][:, :4]
    est = {
        "seed_xyz": gt["point_clouds"][:, :S, :3],
        "seed_inds": np.tile(np.arange(S, dtype=np.int32), (2, 1)),
        "vote_xyz": gt["point_clouds"][:, :S, :3] + rng.randn(2, S, 3) * 0.2,
        "aggregated_vote_xyz": np.repeat(obj, K // 4, axis=1)
        + rng.randn(2, K, 3) * 0.3,
        "objectness_scores": rng.randn(2, K, 2),
        "heading_scores": rng.randn(2, K, 12),
        "heading_residuals_normalized": rng.randn(2, K, 12) * 0.3,
        "size_scores": rng.randn(2, K, 8),
        "size_residuals_normalized": rng.randn(2, K, 8, 3) * 0.3,
        "sem_cls_scores": rng.randn(2, K, 8),
    }
    est["center"] = est["aggregated_vote_xyz"] + rng.randn(2, K, 3) * 0.1
    est = {k: v.astype(np.int32 if k == "seed_inds" else np.float32)
           for k, v in est.items()}
    return est, gt


def test_detection_loss_terms_and_gradients():
    """Every term of the detection loss, and the gradient of the total
    with respect to every float end point."""
    est, gt = _detection_inputs(3)
    dc = ScannetConfig()
    want = jlosses.detection_loss({k: jnp.asarray(v) for k, v in est.items()},
                                  {k: jnp.asarray(v) for k, v in gt.items()}, dc)
    test = {k: t(v).requires_grad_(v.dtype == np.float32)
            for k, v in est.items()}
    got = tlosses.detection_loss(test, torch_batch(gt), tconfig.MEAN_SIZE_ARR)
    assert set(got) == set(want)
    assert 0 < float(want["pos_ratio"]) < 1
    for k in want:
        assert_close(got[k], want[k], what=k)
    floats = [k for k, v in est.items() if v.dtype == np.float32]
    jgrad = jax.grad(lambda e: jlosses.detection_loss(
        {**{k: jnp.asarray(v) for k, v in est.items()}, **e},
        {k: jnp.asarray(v) for k, v in gt.items()}, dc)["total"])(
        {k: jnp.asarray(est[k]) for k in floats})
    got["total"].backward()
    for k in floats:
        grad = test[k].grad if test[k].grad is not None else torch.zeros(
            est[k].shape)
        assert_close(grad, jgrad[k], what=k)
    onet = tlosses.onet_loss(torch.tensor(2.0), torch.tensor(0.5), 0.005)
    assert float(onet["total_loss"]) == pytest.approx(0.005 * (2.0 + 50.0))


def test_select_completion_proposals_matches_jax():
    """Ranks, GT ids and classes exact, with tied objectness."""
    rng = np.random.RandomState(4)
    gt = synthetic_scene_batch(rng, batch_size=2, num_points=512,
                               mean_size_arr=tconfig.MEAN_SIZE_ARR)
    probs = np.round(rng.rand(2, 40), 1).astype(np.float32)  # many ties
    center = (np.repeat(gt["center_label"][:, :4], 10, axis=1)
              + rng.randn(2, 40, 3) * 0.2).astype(np.float32)
    args = (probs, center, gt["center_label"], gt["box_label_mask"],
            gt["sem_cls_label"])
    want = jselect(*[jnp.asarray(a) for a in args], 10)
    got = select_completion_proposals(*[t(a) for a in args], 10)
    assert_equal(got, want)


def test_step_generator_depends_on_its_place_only():
    from rfdnet_tpu_torch.train.loop import step_generator

    draw = lambda *a: torch.randn(4, generator=step_generator(*a, "cpu"))
    assert torch.equal(draw(10, 2, "train", 3), draw(10, 2, "train", 3))
    others = [draw(10, 2, "val", 3), draw(10, 3, "train", 3),
              draw(10, 2, "train", 4), draw(11, 2, "train", 3)]
    assert not any(torch.equal(draw(10, 2, "train", 3), o) for o in others)


# --------------------------------------------------------------- schedules
def test_plateau_and_bn_momentum_over_60_epochs():
    jcfg = Config(os.path.join(ROOT, "configs", "iscnet.yaml"), mode="train",
                  make_dirs=False)
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "iscnet.yaml"),
                              mode="train")
    rng = np.random.RandomState(9)
    losses = np.concatenate([np.linspace(10, 5, 15),
                             5 + 0.01 * rng.rand(45)])
    jp = jtrainer.PlateauScheduler(lr=5e-5, patience=5)
    tp = ttrainer.PlateauScheduler(lr=5e-5, patience=5)
    lrs = set()
    for epoch, loss in enumerate(losses):
        assert tconfig.bn_momentum(cfg, epoch) == jcfg.bn_momentum(epoch)
        assert tp.step(float(loss)) == jp.step(float(loss))
        lrs.add(tp.lr)
    assert len(lrs) > 2
    assert tconfig.bn_momentum(cfg, 59) == 0.5 * 0.5 ** 2


def test_optimizer_specs_match_jax():
    jcfg, cfg = train_configs("stage3_joint")
    spec_of = ttrainer.make_optimizer_with_specs(cfg["optimizer"],
                                                 cfg["model"])
    assert spec_of("detection") == ttrainer.AdamSpec(
        (0.9, 0.999), 1e-8, 0.0, pytest.approx(1e-5 / 5e-5))
    assert spec_of("backbone") == ttrainer.AdamSpec(
        (0.9, 0.999), 1e-8, 1e-4, 1.0)
    _, scale_tree = jtrainer.make_optimizer_with_specs(
        jcfg.config["optimizer"], jcfg.config["model"])
    scales = scale_tree({"detection": {"a": 0}, "backbone": {"a": 0}})
    assert spec_of("detection").lr_scale == pytest.approx(
        scales["detection"]["a"])


# ---------------------------------------------------------------- data
@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return write_scannet_scenes(str(root), 2, num_points=2048)


def test_dataset_train_items_and_loader_order(on_disk):
    """Train-mode items (augmentation, point and occupancy subsampling)
    equal the JAX package's for two epochs, and so does the shuffled
    order of the loader."""
    split = os.path.join(on_disk["split"], "scannetv2_train.json")
    kw = dict(mode="train", phase="completion", num_points=1024,
              shapenet_path=on_disk["shapenet_path"], seed=3)
    jds = jscannet.ScanNetDataset(split, dataset_config=ScannetConfig(), **kw)
    tds = tscannet.ScanNetDataset(split, **kw)
    assert tds.augment and jds.augment
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            want, got = jds[i], tds[i]
            assert set(got) == set(want)
            for k in want:
                assert_equal(got[k], want[k], what=f"{epoch} {i} {k}")
    jl = jscannet.DataLoader(jds, batch_size=1, shuffle=True, num_workers=1,
                             seed=3)
    tl = tscannet.DataLoader(tds, batch_size=1, shuffle=True, num_workers=1,
                             seed=3)
    orders = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want = [list(b["scan_idx"]) for b in jl]
        got = [list(b["scan_idx"]) for b in tl]
        assert got == want
        orders.append(got)
    assert orders[0] != orders[1]


# ------------------------------------------------------------ checkpoints
def _tiny_model(seed=0):
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "iscnet.yaml"),
                              mode="train")
    tconfig.update_recursive(cfg, SMALL)
    return cfg, init_seeded(tconfig.build_model(cfg, device="cpu",
                                                mode="train"), seed)


def test_flax_flat_is_the_jax_layout():
    """`flax_flat` writes the flat flax paths of the JAX model's own
    variables, and `from_flax` reads them back unchanged."""
    jcfg, cfg = train_configs("stage3_joint")
    port = tconfig.build_model(cfg, device="cpu", mode="train")
    variables = step_variables("completion")
    port.load_state_dict(from_flax(variables))
    flat = flax_flat(port)
    want = {}
    for kind in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables[kind])[0]:
            want["/".join((kind, *(p.key for p in path)))] = np.asarray(leaf)
    assert set(flat) == set(want)
    for k in want:
        assert_equal(flat[k], want[k], what=k)


def test_checkpoint_round_trip_copy_and_partial_load(tmp_path):
    cfg, model = _tiny_model(0)
    trainer = Trainer(cfg, model)
    for p in trainer.optimizer.params:
        p.grad = torch.ones_like(p)
    trainer.optimizer.step(1e-3)
    io = tcheckpoint.CheckpointIO(str(tmp_path / "run"), log=lambda m: None)
    io.save_best(model, trainer.optimizer, {"epoch": 4, "min_loss": 2.5,
                                            "lr": 1e-4})
    io.copy("model_best", "model_last")
    assert sorted(os.listdir(tmp_path / "run")) == sorted(
        f"model_{n}{s}" for n in ("best", "last")
        for s in (".npz", ".opt.npz", ".json"))
    _, other = _tiny_model(1)
    other_trainer = Trainer(cfg, other)
    meta = io.load(str(tmp_path / "run" / "model_last"), other,
                   other_trainer.optimizer)
    assert meta == {"epoch": 4, "min_loss": 2.5, "lr": 1e-4}
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert other_trainer.optimizer.count == 1
    for a, b in zip(other_trainer.optimizer.nu, trainer.optimizer.nu):
        assert torch.equal(a, b)
    # a detection-phase model takes what it shares, and reports the rest
    det_cfg = tconfig.load_config(os.path.join(
        ROOT, "configs", "iscnet_detection.yaml"), mode="train")
    tconfig.update_recursive(det_cfg, SMALL)
    det = tconfig.build_model(det_cfg, device="cpu", mode="train")
    lines = []
    io.finetune(det, str(tmp_path / "run" / "model_best"))
    tcheckpoint.partial_load(det, {**model.state_dict(),
                                   "voting.conv1.weight": torch.zeros(3)},
                             log=lines.append)
    assert lines == ["{'voting'} subnet missed.",
                     "['backbone', 'detection'] subnet weights loaded."]
    assert torch.equal(det.backbone.sa1.mlp.dense0.weight,
                       model.backbone.sa1.mlp.dense0.weight)


def test_resume_takes_the_newest_run_else_finetune(tmp_path, on_disk):
    """`resume: true` loads the newest sibling run's `model_last` and goes
    on from the epoch after it; without one, `finetune` loads the weights
    of `weight:`."""
    from rfdnet_tpu_torch.train.loop import train

    cfg, model = _tiny_model(0)
    log = []
    io_old = tcheckpoint.CheckpointIO(str(tmp_path / "a_old"), log=log.append)
    io_old.save_last(model, Trainer(cfg, model).optimizer,
                     {"epoch": 1, "min_loss": 3.0, "lr": 2e-5})
    _, newer = _tiny_model(1)
    io_new = tcheckpoint.CheckpointIO(str(tmp_path / "b_new"), log=log.append)
    io_new.save_last(newer, Trainer(cfg, newer).optimizer,
                     {"epoch": 2, "min_loss": 2.0, "lr": 3e-5})
    cfg.update(resume=True, finetune=True,
               weight=[str(tmp_path / "a_old" / "model_last")])
    cfg["train"]["epochs"] = 3  # nothing left to train after epoch 2
    _, fresh = _tiny_model(2)
    io = tcheckpoint.CheckpointIO(str(tmp_path / "c_run"), log=log.append)
    trainer = train(cfg, fresh, [], [], checkpoint=io, log=log.append)
    assert trainer.plateau.lr == 3e-5 and trainer.plateau.best == 2.0
    assert any(m.endswith("b_new/model_last") for m in log)
    for k, v in newer.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # no run to resume from: finetune
    cfg["train"]["epochs"] = 0
    _, fresh2 = _tiny_model(3)
    io2 = tcheckpoint.CheckpointIO(str(tmp_path / "elsewhere" / "run"),
                                   log=log.append)
    train(cfg, fresh2, [], [], checkpoint=io2, log=log.append)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh2.state_dict()[k], v), k


# -------------------------------------------------------------------- CLI
def test_cli_train_then_test(on_disk, tmp_path, monkeypatch, capsys):
    """`--mode train --device cpu` for 2 epochs of 2 scenes at 2048 points
    (completion phase, the widths of SMALL), then `--mode test` on its
    `model_best`."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(ROOT, "configs", "iscnet.yaml")) as f:
        train_cfg = yaml.safe_load(f)
    update_recursive(train_cfg, {
        "finetune": False, "weight": [], "seed": 0,
        "device": {"num_workers": 2},
        "data": {**SMALL["data"], "num_point": 2048,
                 "split": on_disk["split"],
                 "shapenet_path": on_disk["shapenet_path"]},
        "train": {"epochs": 2, "batch_size": 2},
        "val": {"batch_size": 2},
        "log": {"path": str(tmp_path / "out" / "iscnet"), "vis_step": 1}})
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(train_cfg))
    trainer = cli.main(["--config", str(tmp_path / "train.yaml"),
                        "--mode", "train", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mode: train" in printed and "val epoch 1 done" in printed
    runs = os.listdir(tmp_path / "out" / "iscnet")
    assert len(runs) == 1
    run = tmp_path / "out" / "iscnet" / runs[0]
    files = os.listdir(run)
    for name in ("model_best.npz", "model_last.npz", "model_last.opt.npz",
                 "log.txt", "out_config.yaml", "scalars.jsonl"):
        assert name in files, name
    assert json.load(open(run / "model_last.json"))["epoch"] == 1
    steps = trainer.step_times
    assert [(s["epoch"], s["phase"]) for s in steps] == [
        (0, "train"), (0, "val"), (1, "train"), (1, "val")]
    pngs = os.listdir(run / "visualization")
    assert any(p.endswith("_pred.png") for p in pngs)
    assert trainer.optimizer.count == 2

    with open(os.path.join(ROOT, "configs", "iscnet_test.yaml")) as f:
        test_cfg = yaml.safe_load(f)
    update_recursive(test_cfg, {
        "seed": 0, "weight": [str(run / "model_best")],
        "data": {**SMALL["data"], "num_point": 2048,
                 "split": on_disk["split"],
                 "shapenet_path": on_disk["shapenet_path"]},
        "generation": {"resolution_0": 6, "dump_threshold": 0.05}})
    (tmp_path / "test.yaml").write_text(yaml.safe_dump(test_cfg))
    build = tconfig.build_model
    monkeypatch.setattr(cli, "build_model", lambda cfg, device=None: build(
        cfg, generate_limit=4, device=device))
    metrics = cli.main(["--config", str(tmp_path / "test.yaml"),
                        "--mode", "test", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "set() subnet missed." in printed
    assert "mAP @0.5" in metrics and all(np.isfinite(v)
                                         for v in metrics.values())


def test_cli_train_refuses_without_card(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", os.path.join(ROOT, "configs", "iscnet.yaml"),
                  "--mode", "train"])
