"""The readings that a cell's limits are set from, on the card at the
cell's own size, many seeds in one process:

- `program`: the program against the reference, as a run compares it
  (the lower reading is the largest over the seeds);
- `control`: the reference computed in TF32, the precision just below
  the configuration's float32, against the reference in float32 (the
  upper reading is the smallest);
- for a train cell, each fault of the train step planted in the program
  (`FAULTS`): a step that leaves its state unchanged, half of the batch
  left out (the mean taken over the rest), the update applied twice;
  `witness`, the program run again on the same seed against its first
  run; and each checked step's loss on every side.

Run from the root of a checkout on a card: `python3
benchmark/rfdbench/readings.py --workload <name> --seeds <n> ...
[--fault-seeds <n> ...]`; one JSON line a seed (and a fault) on
standard output."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(1, os.getcwd())

from rfdbench import compare, harness  # noqa: E402


def _unchanged(orig):
    """A train step that computes its loss and gradient but leaves the
    parameters and the optimizer's state as they were."""
    def step(model, optimizer, batch, lr, completion_weight=1.0, eps=None,
             generator=None):
        for p in optimizer.params:
            p.grad = None
        model.train()
        out = model(batch, eps=eps)
        losses = model.loss(out, batch, completion_weight)
        losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}
    return step


def _half(orig):
    """A train step on the first half of the batch alone."""
    def step(model, optimizer, batch, lr, completion_weight=1.0, eps=None,
             generator=None):
        n = batch["point_clouds"].shape[0] // 2
        half = {k: v[:n] for k, v in batch.items()}
        return orig(model, optimizer, half, lr, completion_weight,
                    eps=None if eps is None else eps[:eps.shape[0] // 2])
    return step


def _double(orig):
    """A train step whose update is applied twice over."""
    def step(model, optimizer, batch, lr, completion_weight=1.0, eps=None,
             generator=None):
        return orig(model, optimizer, batch, 2 * lr, completion_weight,
                    eps=eps)
    return step


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "double": _double}


def program_run(cell, seed, device, requests):
    """The cell's driver set up on `seed`; a serve cell then sends
    `requests` requests (the window's first ones, which a run keeps)."""
    driver = harness.load_module(cell.driver_path, "readings_driver")
    ctx = harness.Context(cell, seed, device)
    run = driver.Run(ctx)
    if cell.traffic["driver"] == "serve":
        for i in range(requests):
            run.kept[i] = run.request(i, run.buffer(i))
    return run


def free(run) -> None:
    import torch

    run.release()
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser("readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = harness.Cell(root, args.workload)
    device = torch.device("cuda", 0)
    # a serve cell's requests: the two cycles of its batches that a run keeps
    requests = 2 * cell.traffic["distinct_batches"]
    train = cell.traffic["driver"] == "train"
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = program_run(cell, seed, device, requests)
        first = getattr(run, "got", None)
        free(run)
        row = {"seed": seed, "program": run.check(control=True),
               "control": run.control_readings}
        if train:
            row["losses"] = {"program": first["losses"],
                             "reference": run.expected["losses"],
                             "control": run.control_expected["losses"]}
            again = program_run(cell, seed, device, requests)
            free(again)
            row["witness"] = compare.trained(again.got, first)
            row["losses"]["witness"] = again.got["losses"]
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    if train:
        from rfdnet_tpu_torch.train import trainer

        orig = trainer.train_step
        for seed in args.fault_seeds:
            for name, fault in FAULTS.items():
                trainer.train_step = fault(orig)
                try:
                    run = program_run(cell, seed, device, requests)
                finally:
                    trainer.train_step = orig
                free(run)
                print(json.dumps({"seed": seed, "fault": name,
                                  "numbers": run.check()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
