"""CLI entry point: `python -m rfdnet_tpu_torch --config <yaml> --mode demo
--demo_path <scan> [--device cpu]`.

Counterpart of `rfdnet_tpu/cli.py`: one argparse surface, config load,
seeding, then mode dispatch. It runs on the current CUDA card unless
`--device` names another device. `--mode train` and `--mode test` are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import load_config
from .weights import init_seeded, load_npz


def restore_weights(cfg: dict, model, log=print):
    """Seeded init from `cfg["seed"]`, then for each path under `weight:`
    a partial load of `<path>.npz` (the export of a JAX checkpoint
    directory by `tools/export_torch_weights.py`, see `weights.load_npz`).
    A path without its `.npz` is reported and the init kept."""
    init_seeded(model, cfg.get("seed", 10))
    for w in cfg.get("weight", []):
        if os.path.isfile(f"{w}.npz"):
            load_npz(model, f"{w}.npz", log=log)
        else:
            log(f"Warning: weight path {w} not found.")
    return model


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        "rfdnet_tpu_torch: RfD-Net in PyTorch on one CUDA card")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment yaml (reference schema)")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "test", "demo"])
    parser.add_argument("--demo_path", type=str,
                        default="demo/inputs/scene0549_00.off")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the current CUDA card; "
                             "without one, only an explicit 'cpu' runs)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config, mode=args.mode)
    seed = cfg.get("seed", 10)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"mode: {args.mode}")
    if args.mode == "train":
        raise NotImplementedError(
            "--mode train is not ported (ROADMAP.md, 'Training')")
    if args.mode == "test":
        raise NotImplementedError(
            "--mode test is not ported (ROADMAP.md, 'The Tester with GT "
            "fields')")
    from .demo import run as run_demo  # demo imports this module

    return run_demo(cfg, args.demo_path, device=args.device)


if __name__ == "__main__":
    main()
