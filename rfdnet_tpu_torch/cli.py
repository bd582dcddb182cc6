"""CLI entry point: `python -m rfdnet_tpu_torch --config <yaml> --mode
{train,test,demo} [--demo_path <scan>] [--device cpu] [--profile DIR]`.

Counterpart of `rfdnet_tpu/cli.py`: one argparse surface, config load,
seeding, then mode dispatch. It runs on the current CUDA card unless
`--device` names another device. `--mode train` trains one stage
(`train.loop.train`: Adam steps with the plateau LR and BN-momentum
schedules, freezing, a val pass each epoch) in a new run directory
`<log.path>/<ISO time>/`, which receives `model_best` and `model_last`;
with more than one visible card and no `--device`, it runs data
parallel over `train.loop.pick_world` of them, one process a card under
NCCL (`run_train_ranks`), as the JAX CLI's `pick_mesh` spreads a step
over `jax.devices()`.
`--mode test` evaluates the val split (`Tester`: mAP/AR per IoU threshold
and per-class voxel IoU, printed as a table; the per-scene dumps under
`out/test/visualization` with `generation.dump_results`). `--profile DIR`
traces the whole mode with `torch.profiler` into `DIR/trace.json`
(`utils/profiling.trace`).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from . import resolve_device
from .config import build_model, load_config
from .utils.logging import LogBoard, initiate_environment, make_run_dir
from .weights import init_seeded, load_npz


def restore_weights(cfg: dict, model, log=print):
    """Seeded init from `cfg["seed"]`, then for each path under `weight:`
    a partial load of `<path>.npz` (the export of a JAX checkpoint
    directory by `tools/export_torch_weights.py`, see `weights.load_npz`),
    reported with its path. A path without its `.npz` is reported and the
    init kept."""
    init_seeded(model, cfg.get("seed", 10))
    for w in cfg.get("weight", []):
        if os.path.isfile(f"{w}.npz"):
            load_npz(model, f"{w}.npz", log=log)
            log(f"loaded weights {w}.npz")
        else:
            log(f"Warning: weight path {w} not found.")
    return model


def _build_loaders(cfg: dict, modes, group=None):
    """{mode: DataLoader} over `<data.split>/scannetv2_<split>.json`, the
    dataset as the mode's section and `data` describe it; with a data
    `group`, each loader reads its rank's rows of each batch."""
    from .data.scannet import DataLoader, ScanNetDataset

    d = cfg["data"]
    loaders = {}
    for mode in modes:
        split_mode = {"train": "train", "val": "val", "test": "val"}[mode]
        ds = ScanNetDataset(
            os.path.join(d["split"], f"scannetv2_{split_mode}.json"),
            mode=mode,
            phase=cfg[mode]["phase"],
            num_points=d["num_point"],
            use_color_detection=d["use_color_detection"],
            use_color_completion=d["use_color_completion"],
            use_height=not d["no_height"],
            points_subsample=d["points_subsample"],
            points_unpackbits=d["points_unpackbits"],
            shapenet_path=d.get("shapenet_path"),
            seed=cfg.get("seed", 10),
            augment=d.get("augment"),
            cache_scans=int(d.get("cache_scans", 0)),
            cache_shapenet=int(d.get("cache_shapenet", 256)),
        )
        loaders[mode] = DataLoader(
            ds,
            batch_size=cfg[mode].get("batch_size", 1),
            shuffle=mode == "train",
            num_workers=cfg["device"].get("num_workers", 8) or 1,
            seed=cfg.get("seed", 10),
            # `device.worker_type`, threads by default where the JAX
            # package's CLI takes "auto" (processes): on the card's 8-core
            # host processes assembled no more items a second and waited
            # longer a train step (PERF.md, "Loader")
            worker_type=cfg["device"].get("worker_type", "thread"),
            shard=(group.rank, group.world) if group is not None else (0, 1),
        )
    return loaders


def format_ap_table(metrics: dict, thresholds) -> list:
    """Per-class AP/AR table for each threshold (with the mesh AP's
    `mAP_mesh` and `AR_mesh` when present), then the voxel IoUs."""
    lines = []
    for t in thresholds:
        lines.append(f"----- AP @ IoU {t} -----")
        lines.append(f"{'class':<16}{'AP':>10}{'Recall':>10}")
        for k in sorted(metrics):
            if k.endswith(f"Average Precision @{t}"):
                cls = k[: -len(f" Average Precision @{t}")]
                rec = metrics.get(f"{cls} Recall @{t}", 0.0)
                lines.append(f"{cls:<16}{metrics[k]:>10.4f}{rec:>10.4f}")
        for agg in ("mAP", "AR", "mAP_mesh", "AR_mesh"):
            key = f"{agg} @{t}"
            if key in metrics:
                lines.append(f"{agg:<16}{metrics[key]:>10.4f}")
    for k, v in sorted(metrics.items()):
        if "voxel IoU" in k:
            lines.append(f"{k}: {v:.4f}")
    return lines


def run_test(cfg: dict, device=None, log=print, overlap: bool = True):
    """Evaluate the val split with the configured weights on `device` (the
    current CUDA card when None); print the AP table. Returns
    (metrics, tester)."""
    from .eval.tester import Tester

    dev = resolve_device(device)
    loaders = _build_loaders(cfg, ["test"])
    model = restore_weights(cfg, build_model(cfg, device=dev), log=log)
    tester = Tester(cfg, model, log=log)
    thresholds = cfg["test"].get("ap_iou_thresholds", [0.5])
    dump_dir = None
    if cfg["generation"].get("dump_results"):
        dump_dir = os.path.join("out/test", cfg["log"]["vis_path"])
    metrics = tester.run(loaders["test"], ap_iou_thresholds=thresholds,
                         dump_dir=dump_dir, overlap=overlap)
    for line in format_ap_table(metrics, thresholds):
        log(line)
    return metrics, tester


def run_train(cfg: dict, device=None, group=None):
    """Train one stage on `device` (the current CUDA card when None): the
    model initialised from `seed` with the JAX package's distributions,
    then resumed or finetuned as the config says, in a new run directory.
    With no `device` and more than one visible card, `run_train_ranks`
    over `pick_world` of them, which returns each rank's `rank_summary`.
    With a data `group` (a rank of that run), this rank's part; rank 0
    alone makes the run directory and writes to it. Returns the
    `train.loop.Trainer`."""
    from .train.checkpoint import CheckpointIO
    from .train.loop import pick_world, train

    if device is None and group is None and torch.cuda.device_count() > 1:
        world = pick_world(cfg["train"]["batch_size"],
                           torch.cuda.device_count())
        if world > 1:
            return run_train_ranks(cfg, world, "nccl")
    dev = resolve_device(device)
    lead = group is None or group.rank == 0
    save_path, log = make_run_dir(cfg) if lead else (None, lambda msg: None)
    loaders = _build_loaders(cfg, ["train", "val"], group)
    model = init_seeded(build_model(cfg, device=dev, mode="train"),
                        cfg.get("seed", 10), noise=0.0)
    board = LogBoard(save_path) if lead else None
    try:
        return train(cfg, model, loaders["train"], loaders["val"],
                     checkpoint=CheckpointIO(save_path, log=log)
                     if lead else None,
                     board=board, log=log, group=group)
    finally:
        if board is not None:
            board.close()


def rank_summary(group, cfg: dict) -> dict:
    """`run_train` on one rank of `group` (on its device); what the
    process hands back: the run directory (rank 0's), the step times and
    a digest of the final parameters' bytes (equal on every rank)."""
    import hashlib

    initiate_environment(cfg.get("seed", 10))
    trainer = run_train(cfg, device=group.device, group=group)
    digest = hashlib.sha1()
    for p in trainer.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return dict(rank=group.rank, save_path=trainer.save_path,
                step_times=trainer.step_times, digest=digest.hexdigest())


def run_train_ranks(cfg: dict, world: int, backend: str = "nccl") -> list:
    """`run_train` data parallel over `world` ranks, one process each
    (`parallel.mesh.run_ranks`: NCCL with rank r on card r, or gloo on
    the CPU). Returns each rank's `rank_summary`."""
    from .parallel.mesh import run_ranks

    return run_ranks(rank_summary, world, backend, cfg)


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
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the run "
                             "to DIR/trace.json")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config, mode=args.mode)
    initiate_environment(cfg.get("seed", 10))
    print(f"mode: {args.mode}")
    ctx = contextlib.nullcontext()
    if args.profile:
        from .utils.profiling import trace

        ctx = trace(args.profile)
    with ctx:
        if args.mode == "train":
            return run_train(cfg, device=args.device)
        if args.mode == "test":
            return run_test(cfg, device=args.device)[0]
        from .demo import run as run_demo  # demo imports this module

        return run_demo(cfg, args.demo_path, device=args.device)


if __name__ == "__main__":
    main()
