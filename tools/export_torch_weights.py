#!/usr/bin/env python3
"""Export a checkpoint of `rfdnet_tpu` for the PyTorch port.

`rfdnet_tpu` saves its checkpoints as orbax directories
(`train/checkpoint.py`), which need JAX to be read; `rfdnet_tpu_torch`
imports none. This tool runs where JAX and orbax are installed: it
restores a checkpoint directory (`model_best`, `model_last`) and writes
the network weights as one flat `.npz` whose keys are the flax paths
(`params/<module>/.../kernel`, `batch_stats/<module>/.../mean`), the file
that `rfdnet_tpu_torch.weights.load_npz` reads. The port's CLI looks for
`<path>.npz` beside each `<path>` under a config's `weight:`, so by
default the output is the checkpoint directory's name plus `.npz`.

    python3 tools/export_torch_weights.py out/iscnet/<run>/model_best
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flatten(tree, prefix: str) -> dict:
    """{"<prefix>/<path>/<leaf>": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def export(checkpoint_dir: str, out_path: str | None = None) -> str:
    from rfdnet_tpu.train.checkpoint import CheckpointIO

    checkpoint_dir = os.path.abspath(checkpoint_dir)
    state, _ = CheckpointIO(os.path.dirname(checkpoint_dir),
                            log=lambda msg: None).load(checkpoint_dir)
    flat = flatten(state["params"], "params")
    flat.update(flatten(state.get("batch_stats") or {}, "batch_stats"))
    out_path = out_path or checkpoint_dir.rstrip("/") + ".npz"
    np.savez(out_path, **flat)
    return out_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint_dir")
    parser.add_argument("--out", default=None,
                        help="output file (default: <checkpoint_dir>.npz)")
    args = parser.parse_args(argv)
    print(export(args.checkpoint_dir, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
