#!/usr/bin/env python3
"""Time the launch shapes of the resident FPS kernel that can hold a
cloud, at the main path's five FPS shapes and at a few sizes between, on
one CUDA card. The table of `rfdnet_tpu_torch.ops.fps.fps_route` is chosen
from what this prints.

The port's own library holds only the shapes that `fps_route` chooses, so
this builds a second one from `csrc/fps.cu` with `FPS_EXTRA_SHAPES`
naming the alternatives (`SHAPES`, each with and without a cluster, and
the stub at every block size). For each cloud: every (cluster, threads,
points per thread) with capacity in [N, 2N], plus the streaming kernel;
each is first held against `fps_plain` (indices equal), then timed with
CUDA events. Then the stub's time per step for every (cluster, threads).
Prints the card's name and power limit, the compiler's register and spill
counts per instantiation, and one JSON line per cloud; with `--out PATH`
the whole result also goes to PATH as JSON. Any launch error or unequal
index ends the sweep nonzero.

With `--batch B` every cloud is B scenes (the cloud scaled by 1 + 0.01 b
for scene b), and each route also reports how many of its clusters the
card runs at once (`active_clusters`).

Run from the repository root: `python3 tools/sweep_fps_routes.py`.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rfdnet_tpu_torch import config, demo  # noqa: E402
from rfdnet_tpu_torch.ops import _native  # noqa: E402
from rfdnet_tpu_torch.ops.fps import (  # noqa: E402
    RESIDENT_ROUTES, FpsRoute, active_clusters, fps_plain, fps_route,
    launch_route)

CLUSTERS = (1, 2, 4, 8, 16)
BLOCKS = (128, 256, 512)
# (threads, points per thread) timed, each with and without a cluster
SHAPES = tuple((t, p) for t in BLOCKS for p in (1, 2, 4, 8, 16)) + (
    (512, 5), (512, 10), (512, 20), (512, 24))


def build_sweep_library():
    """A library of `csrc/fps.cu` with every shape of `SHAPES` and every
    stub beside the port's own; returns it and the compiler's messages."""
    own = {(r.cluster > 1, r.threads, r.ppt, False) for r in RESIDENT_ROUTES}
    own |= {(c, t, 1, True) for c, t, _, _ in own}
    want = {(c, t, p, False) for c in (False, True) for t, p in SHAPES}
    want |= {(c, t, 1, True) for c in (False, True) for t in BLOCKS}
    extra = " ".join("X(%s, %d, %d, %s)" % (str(c).lower(), t, p,
                                            str(s).lower())
                     for c, t, p, s in sorted(want - own))
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _native.BUILD_DIR / "fps_sweep.cu"
    src.write_text(f"#define FPS_EXTRA_SHAPES(X) {extra}\n"
                   f'#include "{_native.CSRC / "fps.cu"}"\n')
    out = _native.BUILD_DIR / "libfps_sweep.so"
    proc = subprocess.run(
        [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout)
    return ctypes.CDLL(str(out)), proc.stdout


def batched(pts, b: int):
    """b scenes of the cloud pts (1, N, 3), scene i scaled by 1 + 0.01 i."""
    scale = 1 + 0.01 * torch.arange(b, device=pts.device)[:, None, None]
    return (pts * scale).contiguous()


def clouds(dev):
    cfg = config.TEST_CONFIG
    data = demo.load_demo_data(chip_smoke.SCENE,
                               num_points=cfg["data"]["num_point"], device=dev)
    out = list(chip_smoke.fps_inputs(data["point_clouds"][..., :3].contiguous()))
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    for n in (4096, 8192, 16384, 32768, 65536, 160000):
        pts = (torch.rand(1, n, 3, generator=g) * 4 - 2).to(dev)
        out.append((f"uniform{n}", pts, 512))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_fps_routes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    lib, log = build_sweep_library()
    ptxas = chip_smoke.fps_resident_ptxas(_native.ptxas_summary(log))
    print(json.dumps({"ptxas": ptxas}), flush=True)
    result = {"nvidia_smi": smi, "ptxas": ptxas, "clouds": [], "stub": []}
    ok = True
    b = int(sys.argv[sys.argv.index("--batch") + 1]) \
        if "--batch" in sys.argv else 1
    all_clouds = [(name, batched(pts, b), npoint)
                  for name, pts, npoint in clouds(dev)]
    for name, pts, npoint in all_clouds:
        n = pts.shape[1]
        want = fps_plain(pts, npoint)
        routes = [FpsRoute("resident", c, t, p) for c in CLUSTERS
                  for t, p in SHAPES if n <= c * t * p <= 2 * n]
        routes.append(FpsRoute("streaming", 1, 1024, 0))
        rows = []
        for route in routes:
            equal = bool(torch.equal(
                launch_route(pts, npoint, route, lib=lib), want))
            ok &= equal
            ms = chip_smoke.cuda_ms(
                lambda: launch_route(pts, npoint, route, lib=lib), 3)
            rows.append(dict(kind=route.kind, cluster=route.cluster,
                             threads=route.threads, ppt=route.ppt,
                             equal=equal, ms=ms,
                             us_per_step=ms * 1e3 / max(npoint - 1, 1),
                             active_clusters=active_clusters(
                                 route, b, lib=lib)
                             if route.kind == "resident" else None))
        rows.sort(key=lambda r: r["ms"])
        chosen = fps_route(n)
        line = dict(name=name, b=b, n=n, npoint=npoint, chosen=str(chosen),
                    routes=rows)
        result["clouds"].append(line)
        print(json.dumps(line), flush=True)
    pts = all_clouds[0][1]
    for c in CLUSTERS:
        for t in BLOCKS:
            stub = FpsRoute("resident", c, t, 1)
            ms = chip_smoke.cuda_ms(
                lambda: launch_route(pts, 2048, stub, stub=True, lib=lib), 3)
            result["stub"].append(dict(cluster=c, threads=t,
                                       us_per_step=ms * 1e3 / 2047))
    print(json.dumps({"stub": result["stub"]}), flush=True)
    if "--out" in sys.argv:
        path = sys.argv[sys.argv.index("--out") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
