"""Checkpoints, with the reference's boot semantics, without orbax.

Counterpart of `rfdnet_tpu/train/checkpoint.py`. A checkpoint `<name>`
of a run directory is three files:
- `<name>.npz`: the model's parameters and running statistics, flat flax
  paths (`weights.flax_flat`), which `weights.load_npz` reads, so that
  `weight: - out/iscnet/<run>/model_best` feeds the next stage and
  `--mode test` alike;
- `<name>.opt.npz`: the Adam moments (`mu/<parameter>`,
  `nu/<parameter>`) and its step count (`count`);
- `<name>.json`: meta (epoch, best val loss, LR).
`resume` scans the sibling run directories newest first for a
`model_last`; `finetune` loads network weights only, partially, with
`partial_load`'s report.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..weights import flax_flat, load_npz, partial_load

__all__ = ["CheckpointIO", "partial_load"]

_SUFFIXES = (".npz", ".opt.npz", ".json")


def _write_npz(path: str, arrays: dict) -> None:
    """np.savez to `path` through a temporary file and a rename."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


class CheckpointIO:
    def __init__(self, save_path: str, log=print):
        self.save_path = os.path.abspath(save_path)
        self.log = log

    def _path(self, name: str) -> str:
        return os.path.join(self.save_path, name)

    def save(self, name: str, model, optimizer=None, meta: dict | None = None):
        os.makedirs(self.save_path, exist_ok=True)
        path = self._path(name)
        _write_npz(path + ".npz", flax_flat(model))
        if optimizer is not None:
            _write_npz(path + ".opt.npz", {
                k: v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v) for k, v in optimizer.state_dict().items()})
        with open(path + ".json.tmp", "w") as f:
            json.dump(dict(meta or {}), f)
        os.replace(path + ".json.tmp", path + ".json")

    def load(self, path: str, model, optimizer=None, log=None) -> dict:
        """Load the checkpoint at `path` (without suffix) into `model` and,
        when given, `optimizer`; returns its meta."""
        load_npz(model, path + ".npz", log=log)
        if optimizer is not None:
            with np.load(path + ".opt.npz") as f:
                optimizer.load_state_dict({k: f[k] for k in f.files})
        if os.path.isfile(path + ".json"):
            with open(path + ".json") as f:
                return json.load(f)
        return {}

    def save_last(self, model, optimizer=None, meta=None):
        self.save("model_last", model, optimizer, meta)

    def save_best(self, model, optimizer=None, meta=None):
        self.save("model_best", model, optimizer, meta)

    def copy(self, src_name: str, dst_name: str):
        """Duplicate a saved checkpoint's files under another name."""
        for suffix in _SUFFIXES:
            src = self._path(src_name) + suffix
            if os.path.isfile(src):
                dst = self._path(dst_name) + suffix
                shutil.copyfile(src, dst + ".tmp")
                os.replace(dst + ".tmp", dst)

    def resume(self, model, optimizer) -> dict | None:
        """Scan the sibling run directories (newest first) for a
        `model_last` and load it; its meta, or None when there is none."""
        parent = os.path.dirname(self.save_path)
        if not os.path.isdir(parent):
            return None
        for run in sorted(os.listdir(parent), reverse=True):
            p = os.path.join(parent, run, "model_last")
            if os.path.isfile(p + ".npz"):
                try:
                    meta = self.load(p, model, optimizer)
                except (OSError, KeyError, ValueError) as e:
                    self.log(f"skipping {p}: {e}")  # a damaged run
                    continue
                self.log(f"resumed from {p}")
                return meta
        return None

    def finetune(self, model, weight_path: str):
        """Load network weights only (parameters and running statistics)
        from `weight_path`, partially; the optimizer is left alone."""
        if not os.path.isfile(weight_path + ".npz"):
            self.log(f"Warning: {weight_path} not found, training from "
                     "scratch.")
            return model
        load_npz(model, weight_path + ".npz", log=self.log)
        self.log(f"finetuned from {weight_path}.npz")
        return model
