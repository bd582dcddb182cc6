"""Run utilities: seeding, the run directory, meters, loss recording,
scalar logging.

Counterpart of `rfdnet_tpu/utils/logging.py` (`initiate_environment`,
`AverageMeter`, `LossRecorder`, `LogBoard`, `clean_log_dirs`) and of the
run directory that `rfdnet_tpu.config.Config` makes in train mode
(`log.path/<ISO time>/` with `log.txt` and `out_config.yaml`).
"""

from __future__ import annotations

import datetime
import json
import os
import random
import shutil
import time

import numpy as np
import torch


def initiate_environment(seed: int) -> None:
    """Seed the host's RNGs: Python's, numpy's and torch's global ones.
    The training steps draw from explicit generators of their own."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_run_dir(cfg: dict):
    """A new run directory `<log.path>/<ISO time>` holding the config
    (`out_config.yaml`, written as JSON, which YAML reads) and a log
    function that prints and appends to its `log.txt`. Returns (path,
    log)."""
    path = os.path.join(cfg["log"]["path"],
                        datetime.datetime.now().isoformat())
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "out_config.yaml"), "w") as f:
        json.dump(cfg, f, indent=1)
    log_file = os.path.join(path, "log.txt")

    def log(msg) -> None:
        print(msg, flush=True)
        with open(log_file, "a") as f:
            f.write(f"{datetime.datetime.now().isoformat(' ')} {msg}\n")

    return path, log


class AverageMeter:
    """Running average over appended values or lists."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        if isinstance(val, (list, tuple)):
            for v in val:
                self.update(v)
            return
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class LossRecorder:
    """An `AverageMeter` per loss key."""

    def __init__(self, batch_size: int = 1):
        self.batch_size = batch_size
        self.loss_recorder: dict[str, AverageMeter] = {}

    def update_loss(self, loss_dict: dict):
        for key, value in loss_dict.items():
            if key not in self.loss_recorder:
                self.loss_recorder[key] = AverageMeter()
            self.loss_recorder[key].update(float(value), self.batch_size)

    def synthesize(self) -> dict:
        return {k: m.avg for k, m in self.loss_recorder.items()}


class LogBoard:
    """Scalar logger: TensorBoard's SummaryWriter when it imports, and
    always a JSONL file (`scalars.jsonl`)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass

    def add_scalars(self, phase: str, scalars: dict, step: int):
        rec = {"phase": phase, "step": step, "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._writer is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(f"{phase}/{k}", float(v), step)

    def close(self):
        self._jsonl.close()
        if self._writer is not None:
            self._writer.close()


# what marks a run directory as holding a checkpoint: the port's files
# (`train.checkpoint`) and the JAX package's checkpoint directories
CHECKPOINT_MARKERS = ("model_last.npz", "model_best.npz", "model_last",
                      "model_best")


def clean_log_dirs(root: str) -> list[str]:
    """Delete the run directories under `root` that hold no checkpoint.
    Returns the removed paths."""
    removed = []
    if not os.path.isdir(root):
        return removed
    for run in os.listdir(root):
        p = os.path.join(root, run)
        if not os.path.isdir(p):
            continue
        if not set(CHECKPOINT_MARKERS) & set(os.listdir(p)):
            shutil.rmtree(p)
            removed.append(p)
    return removed
