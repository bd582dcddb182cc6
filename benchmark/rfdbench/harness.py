"""One run of one cell: read the cell from `BENCHMARK.json`, find its
configuration, traffic, driver, limits and per-layer metric readers by
name, set up, measure for `--seconds`, optionally trace a bounded
segment, check the outputs against the plain reference, and print one
JSON line.

Files found by name (a cell, configuration or metric is added by adding
files; see `benchmark/README.md`):
- `BENCHMARK.json`'s `configs[].file`: the configuration (JSON);
- `benchmark/traffic/<traffic>.json`: the traffic mix, whose `driver`
  names `benchmark/drivers/<driver>.py`;
- `benchmark/limits/<workload>.json`: the limits of the cell's compared
  numbers, with the readings they were set from;
- `benchmark/metrics/<metric>.py`: a per-layer metric's reader,
  `read(ctx) -> float | None`."""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "rfdnet_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the run
    may not load (compared whole: `rfdnet_tpu_torch` is not
    `rfdnet_tpu`)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A workload of `BENCHMARK.json` with its files: `workload`,
    `config` (the configuration file's content), `traffic`, `limits`,
    the end-to-end metrics it reports and its per-layer metrics."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        entry = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = json.loads((self.root / entry["file"]).read_text())
        here = self.root / "benchmark"
        traffic = here / "traffic" / f"{self.workload['traffic']}.json"
        self.traffic = json.loads(traffic.read_text())
        self.limits = json.loads(
            (here / "limits" / f"{name}.json").read_text())["limits"]
        self.driver_path = here / "drivers" / f"{self.traffic['driver']}.py"
        self.metrics_dir = here / "metrics"

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", ())
                          or ("workloads" not in m and m["moves"] in moves)]


class Context:
    """What a driver and a metric reader see of a run."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.window = {}      # the driver's window readings
        self.segment = None   # trace.Segment of a traced run
        self.flops_per_unit = None  # counted on the reference
        self.info = {}        # a driver's shapes for the readers


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, log=None) -> dict:
    """Set up, measure, trace, check: the result line's fields."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    ctx = Context(cell, seed, device)
    driver = load_module(cell.driver_path,
                         f"bench_driver_{cell.traffic['driver']}")
    run = driver.Run(ctx)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    ctx.window = run.window(seconds)
    log(f"window: {ctx.window['units']} units in "
        f"{ctx.window['window_s']:.3f} s")
    if "latencies_ms" in ctx.window:
        lat = sorted(ctx.window["latencies_ms"])
        log(f"latency ms: min {lat[0]:.2f} median {lat[len(lat) // 2]:.2f} "
            f"max {lat[-1]:.2f}")
    if trace:
        ctx.segment = run.traced()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = run.check(count_flops=trace)
    correct = all(value <= cell.limits[name] for name, value in
                  compared.items())
    if trace:
        values = {}
        for m in cell.per_layer:
            reader = load_module(cell.metrics_dir / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        readings = dict(ctx.window, setup_s=setup_s)
        values = {m["name"]: {"value": float(readings[m["name"]]),
                              "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": ctx.window["attempted"],
           "failed": ctx.window["failed"], "metrics": values, "device": dev}
    if trace:
        seg = ctx.segment
        dev.update(busy_s=seg.busy_s, window_s=seg.window_s)
        out["breakdown"] = {"device_ops": seg.device_ops(),
                            "idle_gaps": seg.idle_gaps()}
    out["compared"] = {name: {"value": value, "limit": cell.limits[name]}
                       for name, value in compared.items()}
    return out


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    root = Path.cwd()
    try:
        import rfdnet_tpu_torch  # noqa: F401  the system under test
    except ImportError as err:
        print(f"the program is not here: {err}", file=sys.stderr)
        return 2
    import torch

    cell = Cell(root, args.workload)
    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"modules the run may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
