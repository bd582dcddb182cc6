"""The protocol run on one card inside a time budget.

1. Prints the card's name and power limit (`nvidia-smi`) and builds the
   port's native libraries (`rfdnet_tpu_torch/ops/_native.py`).
2. Writes the protocol dataset, `gen_synthetic_dataset --train 128 --val
   32` at its other defaults, under `<out>/data`.
3. The probe: `protocol_run.main` at two epochs a stage in chunks of two,
   and its test, under `<out>/probe`. A chunk's first epoch is slower (a
   new process reads the scans from disk before its cache holds them), so
   the second gives the steady epoch.
4. Runs `protocol_run.main` under `<out>/run` at `--epochs` (default 100
   60 40, batch 8, chunks of 40) when the probe's times say that the three
   stages and the test end inside `--budget` seconds from the start; else
   at the largest percentage of the three epoch counts that does (each
   rounded down, at least 1). A stage's estimate is its epochs times the
   probe's steady train + val seconds, plus its chunks times the rest of
   the probe chunk's seconds (process start, the cold epoch's extra,
   checkpoints); the test's is the probe's.
5. Writes `<out>/timed.json`: the probe's times, the estimate, the epochs
   run and the seconds of each step. With `--keep DIR` it copies the
   run's `log.txt`, `scalars.jsonl`, configs and `metrics.json`, and
   `timed.json` (no weights), to DIR every 30 s and at the end: for a
   machine that is discarded after the run.

It deletes and writes only `<out>/data`, `<out>/probe`, `<out>/run` and
`<out>/timed.json`. The whole chain runs in one process tree, so that its
weights (~170 MB a checkpoint with Adam's moments) need not outlive it.

Run on a card: `python -m rfdnet_tpu_torch.tools.protocol_run_timed
[--budget 3200] [--keep DIR]`. `--device cpu --train 2 --val 1 --epochs 1
1 1` rehearses it on the CPU (at full width: slow).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import threading
import time

from .. import resolve_device

KEEP_SUFFIXES = ("log.txt", "scalars.jsonl", ".yaml", "metrics.json")
PROBE_EPOCHS = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser("protocol_run_timed")
    p.add_argument("--out", default="out/protocol_run_torch_run")
    p.add_argument("--keep", default=None,
                   help="copy the run's logs, configs and metrics (no "
                        "weights) here as it goes")
    p.add_argument("--train", type=int, default=128)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--epochs", type=int, nargs=3, default=[100, 60, 40])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--chunk", type=int, default=40)
    p.add_argument("--budget", type=float, default=3200.0,
                   help="seconds from the start to the end of the test")
    p.add_argument("--device", default=None)
    return p.parse_args(argv)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def keep_logs(run: str, keep: str) -> None:
    """Copy the run's logs, scalars, configs and metrics (not its
    weights) to `keep`, in the run's layout."""
    for d, _, files in os.walk(run):
        for f in files:
            if f.endswith(KEEP_SUFFIXES):
                src = os.path.join(d, f)
                dst = os.path.join(keep, os.path.relpath(src, run))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(src, dst)


def probe_times(probe: dict) -> dict:
    """{stage: {"chunk_s", "train_s", "val_s"}} from the results of a
    `protocol_run.main` run at PROBE_EPOCHS epochs a stage in one chunk."""
    return {key: {"chunk_s": chunks[0]["seconds"],
                  "train_s": probe["epoch_s"][key]["train"],
                  "val_s": probe["epoch_s"][key]["val"]}
            for key, chunks in probe["chunks"].items()}


def estimate_s(epochs, chunk: int, stages: dict, test_s: float) -> float:
    """The three stages' and the test's seconds at `epochs`."""
    total = test_s
    for e, st in zip(epochs, stages.values()):
        steady = st["train_s"][-1] + st["val_s"][-1]
        total += e * steady + math.ceil(e / chunk) * max(
            st["chunk_s"] - PROBE_EPOCHS * steady, 0.0)
    return total


def fit_epochs(epochs, chunk: int, stages: dict, test_s: float,
               seconds: float):
    """(`epochs`, 100) if they fit in `seconds`, else the largest
    percentage of them (each rounded down, at least 1) that does, and
    ([1, 1, 1], 0) if none does."""
    for pct in range(100, 0, -1):
        scaled = [max(1, e * pct // 100) for e in epochs]
        if estimate_s(scaled, chunk, stages, test_s) <= seconds:
            return scaled, pct
    return [1, 1, 1], 0


def main(argv=None) -> dict:
    args = parse_args(argv)
    t_start = time.time()
    resolve_device(args.device)
    from ..ops import _native
    from . import gen_synthetic_dataset as gen
    from . import protocol_run as pr

    smi = nvidia_smi()
    print(smi, flush=True)
    out = os.path.abspath(args.out)
    data, probe_dir, run = (os.path.join(out, d)
                            for d in ("data", "probe", "run"))
    keep = os.path.abspath(args.keep) if args.keep else None
    device = ["--device", args.device] if args.device else []
    timed = {"nvidia_smi": smi, "seconds": {}}

    def lap(name, t0):
        timed["seconds"][name] = round(time.time() - t0, 1)

    def write_timed():
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "timed.json"), "w") as f:
            json.dump(timed, f, indent=1)
        if keep:
            keep_logs(run, keep)
            os.makedirs(keep, exist_ok=True)
            shutil.copyfile(os.path.join(out, "timed.json"),
                            os.path.join(keep, "timed.json"))

    t0 = time.time()
    if args.device != "cpu":
        _native.build()
    lap("build", t0)
    t0 = time.time()
    for d in (data, probe_dir, run):
        shutil.rmtree(d, ignore_errors=True)
    gen.main(["--out", data, "--train", str(args.train), "--val",
              str(args.val)])
    lap("generate", t0)

    t0 = time.time()
    probe = pr.main(["--root", data, "--out", probe_dir, "--epochs",
                     *[str(PROBE_EPOCHS)] * 3, "--batch", str(args.batch),
                     "--chunk", str(PROBE_EPOCHS), *device])
    shutil.rmtree(probe_dir, ignore_errors=True)
    lap("probe", t0)
    timed["probe"] = probe_times(probe)
    timed["test_s"] = probe["test_s"]

    left = args.budget - (time.time() - t_start)
    epochs, pct = fit_epochs(args.epochs, args.chunk, timed["probe"],
                             probe["test_s"], left)
    timed.update(epochs_asked=args.epochs, epochs=epochs, percent=pct,
                 seconds_left=left, estimate_s=estimate_s(
                     epochs, args.chunk, timed["probe"], probe["test_s"]))
    print(f"epochs {epochs} ({pct} % of {args.epochs}): estimate "
          f"{timed['estimate_s']:.0f} s of {left:.0f} s", flush=True)
    write_timed()

    stop = threading.Event()

    def sync():
        while keep and not stop.wait(30):
            keep_logs(run, keep)

    syncer = threading.Thread(target=sync, daemon=True)
    syncer.start()
    t0 = time.time()
    try:
        pr.main(["--root", data, "--out", run, "--epochs",
                 *map(str, epochs), "--batch", str(args.batch), "--chunk",
                 str(args.chunk), *device])
    finally:
        lap("protocol_run", t0)
        stop.set()
        syncer.join()
        timed["seconds"]["total"] = round(time.time() - t_start, 1)
        write_timed()
    print(json.dumps(timed), flush=True)
    return timed


if __name__ == "__main__":
    main()
