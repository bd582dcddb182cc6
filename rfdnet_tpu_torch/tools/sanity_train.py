"""End-to-end learning check: train on synthetic scenes until the detector
finds the boxes, then score mAP (and, in the completion phase, voxel IoU)
through the Tester.

The port's counterpart of `tools/sanity_train.py`, with its arguments,
scenes, batch order, model, optimizer and Tester config:
- `scenes + 4` synthetic scenes of 4 objects from `RandomState(0)` (the
  last 4 held out for scoring), the batch order from the same state,
  shuffled at each pass over the train scenes;
- `ISCNet(phase=--phase, completion_limit=4, generate_limit=8)` at the
  JAX package's widths, filled with the JAX package's init
  (`weights.init_seeded(..., noise=0)`), Adam at `make_optimizer`'s
  defaults with a constant LR, BN momentum 0.5;
- `--freeze` turns off the updates of the named top-level submodules
  (`train.trainer.freeze`); their batch norms still train, as the JAX
  tool's masked update leaves them;
- `--save-to` / `--finetune-from`: `train.checkpoint.CheckpointIO.save` /
  `.finetune`, the port's npz files (`<path>.npz`, `.opt.npz`, `.json`)
  in place of the orbax directory;
- the Tester's config is the JAX tool's `Config({...}, mode="test")`
  without its `log.path` (the Tester does not read it).
A train step's posterior noise comes from a generator seeded from the step
(`train.loop.step_generator(0, 0, "train", step)`), the stand-in for
`fold_in(PRNGKey(0), step)`.

Run: `python -m rfdnet_tpu_torch.tools.sanity_train [--steps 600]
[--scenes 32] [--phase detection|completion] [--save-to PATH]
[--finetune-from PATH] [--freeze backbone,voting,detection] [--device
cpu]`; on the current CUDA card unless `--device` says otherwise (without
a card and without `--device cpu` it raises). The JAX tool's bar: after 600
detection steps, mAP@0.25 above about 0.5 on the held-out scenes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import MEAN_SIZE_ARR, load_config
from ..data.synthetic import synthetic_scene_batch
from ..eval.tester import Tester
from ..models.common import set_bn_momentum
from ..models.iscnet import ISCNet
from ..train.checkpoint import CheckpointIO
from ..train.loop import step_generator, to_device
from ..train.trainer import Adam, freeze, make_optimizer_with_specs, train_step
from ..weights import init_seeded

VAL_SCENES = 4
NUM_OBJECTS = 4
COMPLETION_LIMIT = 4
GENERATE_LIMIT = 8
BN_MOMENTUM = 0.5
PRINT_EVERY = 100
AP_IOU = 0.25


def parse_args(argv=None):
    p = argparse.ArgumentParser("sanity_train")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--scenes", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--phase", type=str, default="detection",
                   choices=["detection", "completion"])
    p.add_argument("--save-to", type=str, default=None,
                   help="save the final weights (<path>.npz, .opt.npz, "
                        ".json)")
    p.add_argument("--finetune-from", type=str, default=None,
                   help="partial-load weights from <path>.npz")
    p.add_argument("--freeze", type=str, default="",
                   help="comma-separated submodules to freeze")
    p.add_argument("--device", default=None,
                   help="the device to train on (default: the current "
                        "CUDA card)")
    return p.parse_args(argv)


def tester_config(points: int, phase: str) -> dict:
    """The Tester's config: the JAX tool's overrides over the defaults."""
    return load_config({
        "data": {"num_point": points},
        "test": {"phase": phase, "batch_size": 1,
                 "ap_iou_thresholds": [AP_IOU]},
        "generation": {"generate_mesh": False},
    }, mode="test")


def make_scenes(rng: np.random.RandomState, scenes: int, points: int):
    """(train, val): `scenes` + VAL_SCENES batch-1 scenes drawn one after
    the other from `rng`, the last VAL_SCENES held out."""
    drawn = [synthetic_scene_batch(rng, batch_size=1, num_points=points,
                                   num_objects=NUM_OBJECTS,
                                   mean_size_arr=MEAN_SIZE_ARR)
             for _ in range(scenes + VAL_SCENES)]
    return drawn[:scenes], drawn[scenes:]


def stack(items: list) -> dict:
    """Batch-1 scenes concatenated into one batch."""
    return {k: np.concatenate([it[k] for it in items]) for k in items[0]}


def batch_order(rng: np.random.RandomState, scenes: int, batch: int,
                steps: int):
    """The train scenes of each step: `order` shuffled by `rng` at the
    start of each pass of scenes // batch steps, then cut in batches."""
    per_pass = scenes // batch
    order = np.arange(scenes)
    for it in range(steps):
        if it % per_pass == 0:
            rng.shuffle(order)
        yield order[(it % per_pass) * batch:][:batch]


def build_model(phase: str, device, **widths) -> ISCNet:
    """The tool's ISCNet on `device` with the JAX package's init;
    `widths` (c_dim, hidden_dim, z_dim, ...) override the defaults."""
    model = ISCNet(mean_size_arr=MEAN_SIZE_ARR, phase=phase,
                   completion_limit=COMPLETION_LIMIT,
                   generate_limit=GENERATE_LIMIT, **widths)
    return init_seeded(model, 0, noise=0.0).to(device)


def make_optimizer(model: ISCNet, frozen=()) -> Adam:
    """Adam at `make_optimizer`'s defaults over the parameters that
    train (`frozen` submodules get no update)."""
    return Adam(freeze(model, tuple(frozen)), make_optimizer_with_specs({}, {}))


def loss_line(it: int, losses: dict) -> str:
    extra = ""
    if "completion_loss" in losses:
        extra = f" compl {float(losses['completion_loss']):.1f}"
    return (f"step {it}: total {float(losses['total']):.2f} "
            f"obj_acc {float(losses['obj_acc']):.3f} "
            f"box {float(losses['box_loss']):.3f}" + extra)


def train(model: ISCNet, optimizer: Adam, train_scenes: list,
          rng: np.random.RandomState, steps: int, batch: int, lr: float,
          noise=None, log=print) -> list:
    """`steps` Adam steps over `train_scenes` in `batch_order(rng)`, BN
    momentum 0.5. `noise(it)`: the posterior noise of step `it` (None:
    drawn from `step_generator(0, 0, "train", it)`). Returns each step's
    loss terms (floats)."""
    device = next(model.parameters()).device
    set_bn_momentum(model, BN_MOMENTUM)
    history = []
    order = batch_order(rng, len(train_scenes), batch, steps)
    for it, sel in enumerate(order):
        data = to_device(stack([train_scenes[i] for i in sel]), device)
        eps = noise(it) if noise is not None else None
        gen = (step_generator(0, 0, "train", it, device) if eps is None
               else None)
        losses = train_step(model, optimizer, data, lr, eps=eps,
                            generator=gen)
        history.append(losses)
        if it % PRINT_EVERY == 0:
            log(loss_line(it, losses))
    keys = sorted(history[0]) if history else []
    values = (torch.stack([torch.stack([h[k].float() for k in keys])
                           for h in history]).tolist() if history else [])
    return [dict(zip(keys, v)) for v in values]


class SceneLoader:
    """The held-out scenes as a batch-1 loader."""

    batch_size = 1

    def __init__(self, scenes: list):
        self.scenes = scenes

    def __iter__(self):
        yield from self.scenes


def printed(metrics: dict) -> dict:
    """The metrics the JAX tool prints: every mAP, AR and voxel IoU key."""
    return {k: v for k, v in metrics.items()
            if "mAP" in k or "AR" in k or "voxel IoU" in k}


def score(cfg: dict, model: ISCNet, val_scenes: list, log=print) -> dict:
    """The Tester's metrics on `val_scenes` at AP IoU 0.25."""
    tester = Tester(cfg, model, log=log)
    return tester.run(SceneLoader(val_scenes), ap_iou_thresholds=[AP_IOU])


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = tester_config(args.points, args.phase)
    rng = np.random.RandomState(0)
    train_scenes, val_scenes = make_scenes(rng, args.scenes, args.points)
    model = build_model(args.phase, device)
    if args.finetune_from:
        CheckpointIO(os.path.dirname(args.finetune_from) or ".",
                     log=print).finetune(model, args.finetune_from)
    optimizer = make_optimizer(
        model, [s for s in args.freeze.split(",") if s])

    t0 = time.time()
    train(model, optimizer, train_scenes, rng, args.steps, args.batch,
          args.lr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s")

    if args.save_to:
        CheckpointIO(os.path.dirname(args.save_to) or ".", log=print).save(
            os.path.basename(args.save_to), model, optimizer,
            {"steps": args.steps})
    model.eval()
    metrics = score(cfg, model, val_scenes)
    for k, v in printed(metrics).items():
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
