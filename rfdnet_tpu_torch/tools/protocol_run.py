"""The three-stage training chain and the full test protocol on a
protocol-shaped dataset (`tools.gen_synthetic_dataset`), as a user runs
them through the CLI.

The port's counterpart of `tools/protocol_run.py`, with its arguments and
defaults, plus `--device`:
1. detection from scratch, lr 1e-3;
2. completion, lr 1e-4, backbone/voting/detection frozen, finetuned from
   stage 1's `model_best`;
3. joint, lr 5e-5, completion weight 0.005, from stage 2's `model_last`;
then the test protocol (batch 1, dense 32^3 meshes, the mesh mAP, mAP at
IoU 0.25 and 0.5) through the CLI's test mode, in this process. Each stage
trains in `--chunk`-epoch subprocesses, `python -m rfdnet_tpu_torch
--config <stage yaml> --mode train [--device D]`, toward absolute epoch
targets: `resume: true` starts a chunk from the newest run directory's
`model_last`, so a chunk that dies is retried from its checkpoint (three
retries a stage), and a process ends with each chunk (the epoch loop's
host memory goes with it). The schedules are the reference's: plateau
patience 20, factor 0.1, threshold 0.01 (`--stage3-threshold` for stage 3);
BN momentum 0.5 * 0.5^(epoch // 20), at least 0.001.

A stage starts from the newest run directory of the stage before that
holds the file it takes (`predecessor`). The JAX tool takes the newest run
directory's, which a chunk without a new best val loss leaves without a
`model_best`; the CLI then warns and trains from the seeded init. Here
`main` raises before a stage whose file no run directory holds. Stage
configs are written by `config.dump_yaml` (the port reads YAML with its own
parser, and imports no YAML package).

Writes `<out>/metrics.json`: the test metrics, each stage's schedule
evidence (LR reductions, best epochs, the per-epoch lr / BN momentum / val
loss series stitched across its run directories, the newest winning),
each stage's chunks (target epoch, seconds, tries) and the seconds of
each epoch's train and val passes, the weight file each stage and the test
started from, the test's seconds and the wall time.

Run: `python -m rfdnet_tpu_torch.tools.gen_synthetic_dataset --out
out/synth_ds`, then `python -m rfdnet_tpu_torch.tools.protocol_run --root
out/synth_ds --out out/protocol_run_torch [--epochs 100 60 60] [--batch 8]
[--chunk 40] [--device cpu]`; on the current CUDA card unless `--device`
says otherwise (without a card and without `--device cpu` it raises).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

from .. import resolve_device
from ..config import dump_yaml, parse_yaml, update_recursive

N_POINTS = 80_000  # the reference's num_point (`ISCNet.yaml:13`)
# the directory that holds the package, for the chunks' PYTHONPATH
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _stage_yaml(split_dir, shapenet, out_dir, *, phase, lr, epochs, batch,
                freeze=(), weight=(), extra=None, seed=10, save_step=1):
    """Write one stage's config to `<out_dir>/<phase>_<lr>.yaml`; returns
    its path."""
    cfg = {
        "seed": seed,
        "data": {
            "num_point": N_POINTS,
            "split": split_dir,
            "shapenet_path": shapenet,
            # the protocol set (160 scenes) fits in ~1 GB: keep every
            # decoded scan
            "cache_scans": 512,
        },
        "train": {"phase": phase, "batch_size": batch, "epochs": epochs,
                  "freeze": list(freeze)},
        "val": {"phase": phase, "batch_size": batch},
        "optimizer": {"lr": lr},
        "scheduler": {"patience": 20, "factor": 0.1, "threshold": 0.01},
        "device": {"num_workers": 8},
        # model_best saves on every improvement and the last epoch always
        # saves, so the next stage finds a fresh model_last
        "log": {"path": out_dir, "print_step": 16, "save_step": save_step},
        "finetune": bool(weight),
        "weight": list(weight),
        # an interrupted stage resumes at its last checkpoint; a fresh one
        # falls through to finetune / the seeded init
        "resume": True,
    }
    if extra:
        update_recursive(cfg, extra)
    path = os.path.join(out_dir, f"{phase}_{lr}.yaml")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def _run_train(yaml_path, total_epochs, chunk, retries=3, device=None):
    """Train one stage as subprocess chunks toward absolute epoch targets
    (`chunk`, 2 * `chunk`, ..., `total_epochs`), skipping the targets that
    the newest run directory's log has passed, each chunk retried from its
    own checkpoint while the stage's `retries` last. Returns each chunk's
    {"epochs": target, "seconds": wall time, "tries": runs}."""
    with open(yaml_path) as f:
        cfg = parse_yaml(f.read())
    ends = list(range(chunk, total_epochs, chunk)) + [total_epochs]
    done = -1
    for run in sorted(glob.glob(os.path.join(cfg["log"]["path"], "*")),
                      reverse=True):
        log_path = os.path.join(run, "log.txt")
        if os.path.isfile(log_path):
            with open(log_path) as f:
                eps = re.findall(r"train epoch (\d+) done", f.read())
            if eps:
                done = int(eps[-1])
                break
    ends = [e for e in ends if e > done + 1] or [total_epochs]
    argv = [sys.executable, "-m", "rfdnet_tpu_torch", "--config", yaml_path,
            "--mode", "train", *(["--device", device] if device else [])]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PACKAGE_PARENT, os.environ.get("PYTHONPATH")) if p))
    budget = retries
    chunks = []
    for end in ends:
        cfg["train"]["epochs"] = end
        with open(yaml_path, "w") as f:
            f.write(dump_yaml(cfg))
        t0, tries = time.time(), 0
        while True:
            tries += 1
            r = subprocess.run(argv, env=env)
            if r.returncode == 0:
                break
            budget -= 1
            print(f"chunk (target epoch {end}) exited {r.returncode}; "
                  f"{budget} retries left", flush=True)
            if budget < 0:
                raise RuntimeError(
                    f"stage failed at chunk target {end} "
                    f"(exit {r.returncode})")
        chunks.append({"epochs": end, "seconds": time.time() - t0,
                       "tries": tries})
    return chunks


def _run_dir(out_dir):
    runs = sorted(
        d for d in glob.glob(os.path.join(out_dir, "*")) if os.path.isdir(d))
    assert runs, f"no run dir under {out_dir}"
    return runs[-1]


def _schedule_evidence(stage_out_dir):
    """LR reductions, new-best epochs and the per-epoch lr / BN momentum /
    val loss series of every run directory under the stage, stitched into
    one series by epoch (oldest to newest, so a resumed run's epochs
    replace the ones it repeats)."""
    run_dirs = sorted(
        d for d in glob.glob(os.path.join(stage_out_dir, "*"))
        if os.path.isdir(d))
    reductions, best, by_epoch = [], [], {}
    for run_dir in run_dirs:
        log_path = os.path.join(run_dir, "log.txt")
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        reductions += re.findall(
            r"epoch (\d+): plateau patience exceeded, LR (\S+) -> (\S+)", log)
        best += re.findall(r"epoch (\d+): new best val loss (\S+)", log)
        scalars = os.path.join(run_dir, "scalars.jsonl")
        if os.path.isfile(scalars):
            with open(scalars) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("phase") == "schedule":
                        by_epoch[int(rec["epoch"])] = {
                            "epoch": int(rec["epoch"]),
                            "lr": rec["lr"],
                            "bn_momentum": rec["bn_momentum"],
                            "val_total": rec["val_total"],
                        }
    best.sort(key=lambda eb: int(eb[0]))
    return {
        "lr_reductions": [
            {"epoch": int(e), "from": float(a), "to": float(b)}
            for e, a, b in reductions
        ],
        "n_best_epochs": len(best),
        "last_best": (
            {"epoch": int(best[-1][0]), "val_total": float(best[-1][1])}
            if best else None
        ),
        "schedule": [by_epoch[e] for e in sorted(by_epoch)],
    }


def epoch_seconds(stage_out_dir: str) -> dict:
    """{"train": [...], "val": [...]}: the seconds of each epoch's pass as
    the run directories' logs give them (`train.loop`'s `<phase> epoch
    <n> done in <s>s`), by epoch, the newest run winning."""
    by_epoch = {"train": {}, "val": {}}
    for run_dir in sorted(glob.glob(os.path.join(stage_out_dir, "*"))):
        log_path = os.path.join(run_dir, "log.txt")
        if os.path.isfile(log_path):
            with open(log_path) as f:
                for phase, epoch, s in re.findall(
                        r"(train|val) epoch (\d+) done in ([\d.]+)s",
                        f.read()):
                    by_epoch[phase][int(epoch)] = float(s)
    return {phase: [e[k] for k in sorted(e)] for phase, e in by_epoch.items()}


def predecessor(stage_out_dir: str, name: str) -> str:
    """The weight path (`<run dir>/<name>`) a stage starts from: the newest
    run directory of the stage before that holds `<name>.npz`. A chunk
    that found no better val loss writes no `model_best`, and a resumed
    run keeps the stage's best loss, so the newest `model_best` is the
    stage's best. Raises when no run directory holds one (the CLI would
    warn and keep the seeded init)."""
    for run in sorted(glob.glob(os.path.join(stage_out_dir, "*")),
                      reverse=True):
        path = os.path.join(run, name)
        if os.path.isfile(path + ".npz"):
            return path
    raise FileNotFoundError(f"{stage_out_dir}: no run directory holds "
                            f"{name}.npz")


def parse_args(argv=None):
    p = argparse.ArgumentParser("protocol_run")
    p.add_argument("--root", required=True, help="dataset root "
                   "(from rfdnet_tpu_torch.tools.gen_synthetic_dataset)")
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, nargs=3, default=[100, 60, 60],
                   metavar=("E1", "E2", "E3"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--skip-to", type=int, default=1,
                   help="resume chain at stage N (prior run dirs must exist)")
    p.add_argument("--chunk", type=int, default=40,
                   help="epochs per training subprocess")
    p.add_argument("--save-step", type=int, default=1,
                   help="save model_last every N epochs (best: every "
                        "improvement; final epoch: always)")
    p.add_argument("--stage3-threshold", type=float, default=0.01,
                   help="plateau rel-threshold for the joint stage")
    p.add_argument("--device", default=None,
                   help="the device to train and test on (default: the "
                        "current CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    args.root = os.path.abspath(args.root)
    args.out = os.path.abspath(args.out)

    from .. import cli

    split_dir = os.path.join(args.root, "splits")
    shapenet = os.path.join(args.root, "shapenet")
    if not os.path.isfile(os.path.join(split_dir, "scannetv2_train.json")):
        raise FileNotFoundError(f"{split_dir}/scannetv2_train.json: not a "
                                "dataset root")

    t_start = time.time()
    results = {"stages": {}, "chunks": {}, "epoch_s": {}, "weights": {}}
    common = dict(batch=args.batch, seed=args.seed, save_step=args.save_step)

    def stage(key, out_dir, n, epochs, **kw):
        if args.skip_to <= n:
            y = _stage_yaml(split_dir, shapenet, out_dir, epochs=epochs,
                            **common, **kw)
            print(f"=== stage {n}: {key}, {epochs} epochs ===", flush=True)
            results["chunks"][key] = _run_train(y, epochs, args.chunk,
                                                device=args.device)
        results["stages"][key] = _schedule_evidence(out_dir)
        results["epoch_s"][key] = epoch_seconds(out_dir)

    # stage 1: detection from scratch (ISCNet_detection.yaml's deltas)
    out1 = os.path.join(args.out, "stage1_detection")
    stage("detection", out1, 1, args.epochs[0], phase="detection", lr=1e-3)
    # stage 2: completion, detector frozen, from stage 1's best
    out2 = os.path.join(args.out, "stage2_completion")
    w2 = results["weights"]["completion"] = predecessor(out1, "model_best")
    stage("completion", out2, 2, args.epochs[1], phase="completion",
          lr=1e-4, freeze=("backbone", "voting", "detection"), weight=(w2,))
    # stage 3: joint, completion weight 0.005 (ISCNet.yaml)
    out3 = os.path.join(args.out, "stage3_joint")
    w3 = results["weights"]["joint"] = predecessor(out2, "model_last")
    stage("joint", out3, 3, args.epochs[2], phase="completion", lr=5e-5,
          weight=(w3,), extra={"model": {"completion": {"weight": 0.005}},
                               "scheduler": {"threshold":
                                             args.stage3_threshold}})

    # the test protocol in this process (`ISCNet_test.yaml:48-63`): batch
    # 1, dense 32^3 meshes, the mesh mAP, AP at IoU 0.25 and 0.5
    wt = results["weights"]["test"] = predecessor(out3, "model_best")
    test_cfg = {
        "seed": args.seed,
        "data": {"num_point": N_POINTS, "split": split_dir,
                 "shapenet_path": shapenet},
        "test": {"phase": "completion", "batch_size": 1,
                 "evaluate_mesh_mAP": True,
                 "ap_iou_thresholds": [0.25, 0.5]},
        "generation": {"generate_mesh": True, "resolution_0": 32,
                       "upsampling_steps": 0, "dump_results": False},
        "device": {"num_workers": 8},
        "log": {"path": os.path.join(args.out, "test")},
        "weight": [wt],
    }
    ty = os.path.join(args.out, "test.yaml")
    with open(ty, "w") as f:
        f.write(dump_yaml(test_cfg))
    print("=== test protocol: mesh generation + mesh-mAP ===", flush=True)
    t_test = time.time()
    metrics = cli.main(["--config", ty, "--mode", "test",
                        *(["--device", args.device] if args.device else [])])

    results["metrics"] = {
        k: (float(v) if isinstance(v, (int, float)) else v)
        for k, v in metrics.items()
    }
    results["test_s"] = round(time.time() - t_test, 1)
    results["wall_s"] = round(time.time() - t_start, 1)
    results["config"] = {"epochs": args.epochs, "batch": args.batch,
                         "num_points": N_POINTS, "root": args.root,
                         "chunk": args.chunk, "device": args.device}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results["metrics"], indent=2))
    for name, ev in results["stages"].items():
        print(f"{name}: {len(ev['lr_reductions'])} LR reductions, "
              f"last best {ev['last_best']}")
    return results


if __name__ == "__main__":
    main()
