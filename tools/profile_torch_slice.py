#!/usr/bin/env python3
"""Where the time of one scene goes in the PyTorch port, on one CUDA card.

Runs the test config's generation path up to the logit grids
(`rfdnet_tpu_torch.demo.generate_grids`, 80000-point demo scene, seeded
weights) once to warm up, then once under
`torch.profiler` (CPU + CUDA activities), and prints one JSON line:
- the card's name and power limit (`nvidia-smi`);
- `window_ms`: host clock around the profiled scene (ends in a
  synchronise);
- `device_busy_ms`: the union of the CUDA kernel and memcpy/memset
  intervals inside that window, and `idle_share` = 1 - busy / window;
- `top`: device time by kernel name, largest first.
With `--trace PATH`, the Chrome trace of the profiled scene goes to PATH.

Run from the repository root: `python3 tools/profile_torch_slice.py`.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rfdnet_tpu_torch import demo  # noqa: E402


def busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    cfg, data, model = chip_smoke.slice_setup(torch.device("cuda", 0))
    pc = data["point_clouds"]
    demo.generate_grids(cfg, model, pc)  # warm-up: kernel builds, cuBLAS init
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        demo.generate_grids(cfg, model, pc)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in device_events]) / 1e3
    by_name = {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    if "--trace" in sys.argv:
        path = sys.argv[sys.argv.index("--trace") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(path)
    print(json.dumps({
        "nvidia_smi": smi, "window_ms": window_ms,
        "device_busy_ms": busy_ms if device_events else None,
        "idle_share": 1 - busy_ms / window_ms if device_events else None,
        "device_events": len(device_events),
        "top": [{"name": n[:120], "ms": ms} for n, ms in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
