"""Shared by the benchmark's CPU tests: a cell of `BENCHMARK.json` cut to
a size the CPU runs in seconds (2048 points, narrow widths, 8 slots,
6^3 grids, batches of 2), and one run of it on the CPU with the card's
look skipped."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

from rfdbench import harness  # noqa: E402


def tiny_cell(name: str) -> harness.Cell:
    import torch

    torch.set_num_threads(4)
    cell = harness.Cell(ROOT, name)
    cell.config["config"]["data"].update(
        num_point=2048, c_dim=64, hidden_dim=64, z_dim=8,
        completion_limit_in_train=4)
    cell.config["generate_limit"] = 8
    cell.config["config"]["generation"]["resolution_0"] = 6
    cell.traffic.update(batch=2, distinct_batches=3, check_requests=2,
                        trace_requests=1, trace_steps=1)
    if "num_obj_points" in cell.traffic:
        cell.traffic["num_obj_points"] = 64
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 17, trace: bool = False,
             cell=None) -> dict:
    return harness.run_cell(cell or tiny_cell(name), seed, 0.2, trace,
                            "cpu", time.perf_counter(), log=lambda m: None)
