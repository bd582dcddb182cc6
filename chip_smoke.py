#!/usr/bin/env python3
"""Chip smoke test of `rfdnet_tpu_torch` on one NVIDIA GPU (H100).

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA card and exits nonzero, printing no result, without one.
Phases, each printing one JSON line; any failure ends the run nonzero:

1. device: the card's name and power limit (`nvidia-smi`), then the
   CUDA kernels (`nvcc`: FPS, the CBN decoder's f32 and bf16 kernels, the
   prep's depth raster and TSDF fusion, Adam) and the host libraries (`g++`:
   the meshing, the QEM simplification and the KD-tree) built from
   `rfdnet_tpu_torch/csrc/` at once, with each kernel instantiation's
   registers, spills and static shared memory as `ptxas` reports them
   (every route of `fps_route` must find its one instantiation there,
   with no spill; `fps_resident` adds each resident instantiation's
   dynamic shared memory).
2. fps: the FPS kernels against the plain torch version (indices equal)
   at the five shapes of the main path, on the 80000-point demo scene
   (the first five times over), at the detection path's `vote_fps` shape
   (256 of the scene's 1024 votes), and at the shapes that can go wrong apart
   from them: two scenes in a batch, a size just below and just above
   every switch of `fps_route` (the last one takes the streaming kernel),
   near-origin points, more samples than points; and the five shapes of
   a train step at batch 8 (`batch_shapes`: eight scenes, each with the
   route's `active_clusters`, the clusters the card runs at once). Each
   main-path row names
   its route and gives the time per step, `prev_ms` (the streaming kernel,
   which served these shapes before the resident one, at the same shape;
   its indices are held to the plain version too), `bound_ms`
   (operations) and `chain_bound_ms`: its steps times the time of one
   step of the stub kernel (the route's reductions, barriers and
   exchange, no point work), which is the least a chain of dependent
   steps can take on that route (also each `batch_shapes` row's, at
   batch 8). `flag_off`: the kernel with
   `skip_near_origin=False` against the plain version with it (indices
   equal) at SA1's shape at batch 1 and 8 and at a slab of
   `parallel.halo.fps_bucketed` (20000 -> 2048), timed, with launches
   and chain bound;
   and on clouds near the origin at every route, where the flag changes
   the selection.
3. cbn_decode: the fused CBN decoder against its plain version at 64
   proposals x 32^3 points, f32 (csrc/cbn_decoder.cu) and bf16
   (csrc/cbn_decoder_bf16.cu, the tensor cores), and at T = 1000 in both
   (see `cbn_row` for the bf16 reference, limits and controls). Every later phase that holds the
   f32 kernel to its plain version on a path's captured operands holds
   the bf16 kernel to its own on the same operands (`CBN_BF16_ROWS`).
   Then adam: the multi-tensor Adam kernel (csrc/adam.cu) against
   `adam_update_plain` on the stage-3 model's leaves plus a spec with
   weight decay and an LR scale, three steps on card tensors from the
   same gradients: p, mu and nu bit for bit, one launch a step, the
   kernel's ms against its bound by bytes (see `phase_adam`).
4. slice: the test config's generation path at full width (80000
   points, 256 proposals, 64 slots, 32^3 grids, seeded weights), ten
   scenes after a warm-up, twice: to the logit grids on the card
   (`demo.generate_grids`: `wall_ms`) and on to the meshes on the host
   (`demo.generate`: `wall_mesh_ms`). Scene latency and the stage times
   of each span (`utils.profiling`, a `recording()` a scene: device ms
   from the spans' CUDA events, host ms for `demo.d2h` and `demo.mesh`)
   as mean, min and max; triangles per scene and the extractor's thread
   count; the launch count of each kernel in each run's first timed scene
   (the launch counters read from a recording open since the start).
5. mesh: on that scene's meshes, every edge of every mesh shared by
   exactly two faces, every vertex in the padded unit box, and identical
   arrays from the batch route, the per-proposal route and a second
   extraction.
6. reference: the same path on a 4096-point subsample, on the card and on
   the CPU (plain versions), from the same seeded weights: the sampling
   indices, NMS keep mask and selected proposals equal; detection floats,
   skip-propagation features and grids within the stated tolerances;
   meshes equal (faces equal, vertices within `mesh_comparable`'s
   tolerance) for the proposals whose two grids lie on the same side of
   the iso level everywhere, the others counted.
7. mise: a copy of `configs/iscnet_test.yaml` with `upsampling_steps: 2`
   (Occupancy Networks' generation setting: resolution_0 32, two steps,
   R = 128) and this script's seed, on the demo scene at full width: three
   `demo.generate` scenes after a warm-up through the device octree, with
   scene latency to the meshes, per level the active voxels, decoded
   points and CBN launches, the octree's device time (CUDA events), the
   download and host marching cubes times, triangles (every mesh closed);
   launches FPS 5 and CBN one a level (more where a level decodes in
   chunks). On one scene: the card's octree against the host octrees
   (`MiseNative`, and the Python oracle for the active sets) with the same
   decode on the card, active sets equal and grids within 1e-5 x scale; the
   sparse replay's meshes identical to dense marching cubes of
   `reconstruct_dense`; the CBN kernel against its plain version on the
   operands of each level's decode. A 4096-point scene on the card
   against the CPU: indices equal, active counts a level equal, meshes
   equal where `mesh_comparable` allows; with `use_sampling` (one z a
   proposal, the same draw on both devices) the dense grids within
   tolerance. Then `cli.main --mode demo` on the copy: its meshes read back
   and closed, the same launches.
8. mesh_options: `Generator3D`'s options at full width, the test config
   with refine 30 steps, simplify to 5000 faces and normals, through
   `demo.generate` (a warm-up, two timed scenes): the latency split into
   grid decode, extraction, simplify, refine and normals, triangles
   before and after simplify, refine's first and last loss, unit normals,
   launches FPS 5 / CBN 1; marching tetrahedra on the same grids
   (triangles, time, closed); refine (the same draws) and normals of three
   meshes of a 4096-point scene on the card against the CPU.
9. modules: `SetAbstractionMSG` at SA1's shape (80000 -> 2048, two
   radii) against the CPU, and the main path to the grids with
   `data.mlp_bf16` against f32, in turns, with the bf16 run's launches.
10. demo: `rfdnet_tpu_torch.cli.main --mode demo` on the demo scene with a
   copy of `configs/iscnet_test.yaml` (its seed set to this script's, at
   which the seeded weights leave valid slots), in a temporary directory;
   the files it wrote are read back (`scene.html` and `pred.png` among
   them, the HTML's point, mesh and box counts equal to the dumps', no
   "export failed" printed); then the same run with `--profile DIR`,
   whose trace must name both kernels' CUDA functions.
11. detection: `configs/iscnet_detection.yaml` (`vote_fps`, no completion)
   at full width, three scenes after a warm-up, with stage times; on 4096
   points the sampling indices and NMS keep mask equal a CPU run's.
12. tester: two full-width synthetic scenes written in the dataset's
   on-disk layout (80000 points, 12 objects each, a watertight GT mesh
   each) and a copy of `configs/iscnet_test.yaml` pointing at them (seed
   as in `demo`, `evaluate_mesh_mAP: true`): `rfdnet_tpu_torch.cli.main
   --mode test` on the card (metrics with `mAP_mesh` and `AR_mesh`, the
   dumps read back and their meshes closed, each scene's `scene.html`
   counts equal to its dumps', no "export failed" printed, launches
   counted: FPS 5 and CBN 3 a scene); the Tester's scene time (`wall_scene_ms`) and stages
   without the mesh mAP, with a scene in flight and without, then once
   with it (its `voxelize` stage and `compute_metrics_ms`); the
   CBN kernel against its plain
   version at the two decodes this path adds (the completion loss, 2048
   points with the posterior z, and the 16^3 voxels, 4096 points), on the
   operands the path gives it; and one scene at 4096 points on the card
   against the CPU (same weights): NMS mask, proposal and GT ids equal,
   losses within tolerance, voxel bits equal away from the iso level,
   refit boxes close where both meshes are equal. Then `--mode test` on a
   copy with `upsampling_steps: 2` (`tester_mise`) over the first scene:
   the octree on the card, metrics with the mesh mAP, dumps read back and
   closed.
13. train: eight full-width synthetic scenes (80000 points, 12 objects)
   in the dataset's layout, listed in both the train and the val split,
   and a copy of `configs/iscnet.yaml` (stage 3) with `finetune: false`,
   `weight: []`, `epochs: 3` and this script's seed: `rfdnet_tpu_torch.
   cli.main --mode train` on the card, three Adam steps at batch 8 and
   three val steps. Per step: loader wait, host and device ms, every
   loss term (all finite), the kernel launches (FPS 5, CBN 0 and Adam 1 a
   train step, FPS 5 and CBN 1 a val step); peak device memory; `model_best`
   and `model_last` load through `weights.load_npz`; a fourth epoch with
   `resume: true` starts from epoch 3 (these runs read their items on the
   CLI's default route, threads). Then stages 1
   (`iscnet_detection.yaml`, `vote_fps`) and 2 (`iscnet_completion.yaml`,
   finetuned from stage 1's `model_best`, backbone/voting/detection
   frozen) one step each at 4096 points, batch 2; one stage-3 train
   step at 4096 points on the card against the CPU (`train_reference`);
   and the `loader` line: one pass over the eight train items with 8
   workers for each route (threads, then processes: the pool's first
   pass and a second), the items equal, and a four-epoch stage-3 run at
   batch 8 (four train steps) for each route (`device.worker_type`) with
   its loader wait a step.
14. serve: batched serving (`parallel.serve.make_sharded_generate`) of
   the test config on eight synthetic 80000-point scenes (12 objects
   each): the batch of 8 in one call with no group, the same batch in a
   one-rank NCCL group, and 8 batch-1 calls; ms a batch, scenes a
   second, the per-scene overhead (t_8 / 8) / t_1 - 1, peak memory,
   launches (FPS 5 and CBN 1 a call); the AP tables of the three equal
   exactly, the grids within the CBN tolerance where a slot holds the
   same proposal; the CBN kernel against its plain version on the
   operands of the batch's decode (512 x 32768; the plain version and the
   cuBLAS chain in chunks of 64 proposals).
15. decoder_bf16: the bf16 route (`phase_decoder_bf16`): the demo scene
   at `data.decoder_bf16` against f32 in turns (latency, launches, grids,
   meshes where comparable), a served batch of 8 at bf16, one Tester
   scene at `generation.decoder_impl: pallas` (only the grid decode on
   the bf16 kernel) and the layer chain at bf16 on the card against the
   CPU.
16. point_shard: on the demo scene (80000 points) in a one-rank NCCL
   group, `sa1_forward_sharded` against the model's SA1 (indices equal,
   features within 1e-5 x scale), `ball_query_halo` against `ball_query`
   and `fps_bucketed` with a covering budget against exact FPS (indices
   equal, with and without the near-origin exclusion, two FPS launches a
   call), each timed beside the one-process op.
17. ddp: `cli.run_train` of the stage-3 config at batch 8 on eight
   80000-point scenes, three epochs (a train and a val step each), three
   times: alone, in a one-rank NCCL group (sync-BN, the global-batch
   loss, the gradient all-reduce), alone again (the run-to-run floor:
   the backward's atomic adds sum in any order). The group run against
   the first run, at fixed limits set above the floor: the first train
   step's loss terms and running statistics within 1e-5 relative, its
   gradients within DDP_GRAD_REL (relative L2), every later step's loss
   terms within DDP_STEP_LOSS_REL. The worst single gradient tensor and
   the final parameters are reported, not checked (see `phase_ddp`).
   Device ms a step, the gradient all-reduce's ms, sync-BN all-reduces
   a step, launches.
18. prep: the offline ShapeNet preparation on the first 7 (by name) of
   the 13 checked-in demo meshes (`demo/outputs/scene0549_00/`, one category) and a seeded
   non-watertight mesh of ~50k faces (open boxes, a sphere without its
   cap). On two of them at the CLI's full width (100 views of 640 x 640,
   a 256^3 grid) each kernel against its plain version on the card:
   pixels whose coverage differs and voxels off by over 1e-6 (each at most
   1e-4 of the total), the largest depth and TSDF errors, the kernel's ms
   (CUDA events, 3 launches after a warm-up), the plain version's and the
   bound (FP64 at 34 TFLOP/s or bytes). Then `python -m
   rfdnet_tpu_torch.prep.shapenet` (called in-process, `main(argv)`)
   over all 8 models: exit code 0, one launch of each kernel a model,
   every output file read back, every watertight mesh closed, every
   simplified one below its watertight mesh's faces (the faces are
   printed: the QEM is the JAX package's, which stops above the 5000
   target on these ~3M-face meshes), each model's stage ms (render,
   fuse, tetrahedra, sample, containment, simplify); and its CPU route
   (`--device cpu`) on one model: meshes within half a voxel of the
   card's, occupancy labels equal on at least 99.9 %.
   Then `python -m rfdnet_tpu_torch.prep.scannet` (in-process) on a raw
   ScanNet scene with its Scan2CAD annotation written with numpy
   (`data.synthetic.write_raw_scan2cad_scene`, ~160k scan points), on the
   card and with `--device cpu`: exit code 0 both, the votes made on the
   card, `bbox.pkl` and `scannet_means.npz` equal, `full_scan.npz`'s points
   and labels equal and its votes equal but for at most 1e-4 of the
   points (a point within rounding of a box face may fall on the other
   side; none expected), and no kernel launched.
19. sanity: the learning check's CLI (`rfdnet_tpu_torch.tools.
   sanity_train`, in-process) at a small size: 20 detection steps at
   batch 4 on 8 synthetic 20000-point scenes saved with `--save-to`, then
   10 completion steps from them (`--finetune-from`) with backbone, voting
   and detection frozen (`configs/iscnet_completion.yaml`'s list), each
   scored by the Tester on the tool's 4 held-out scenes: every loss term
   finite, the frozen parameters bit-equal in the two saved files, the
   printed metric keys the JAX tool's, launches FPS 5 a step and a scored
   scene, Adam 1 a step, CBN 2 a scored scene in the completion phase (see
   `phase_sanity`). `sanity_modes` (not a phase; run it on its own)
   scores trained completion weights at f32 and at each bf16 mode.
20. profile_train: `rfdnet_tpu_torch.tools.profile_train --iters 2
   --trace` in-process at batch 8 x 80000 points: every stage a positive
   time, FLOPs counted (nonzero) for every stage but FPS's and ball
   query's, FPS launches a call as `PROFILE_FPS` says, a trace with
   device events.
21. protocol: the protocol dataset and run (`rfdnet_tpu_torch.tools.
   gen_synthetic_dataset` and `.protocol_run`, in-process) at full width
   and a small depth: 8 train and 2 val scenes of the generator's shapes
   (one variant a class, 120000 raw points), one epoch a stage at batch 4
   (each a `--mode train` subprocess), the test protocol with the mesh mAP
   in this process; every stage exits 0 and logs its epoch and schedule,
   stages 2 and 3 and the test load their predecessor's weights, the
   test's launches FPS 5 and CBN 3 a scene (see `phase_protocol`).
Then the `kernels` summary line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`bound_ms` is the least time the card could take for a kernel's work: the
larger of its bytes (inputs read once, outputs written once) over 3.35
TB/s and its operations over the peak rate of their type (67 TFLOP/s f32
outside the tensor cores, 989 TFLOP/s bf16, 34 TFLOP/s FP64 outside the
tensor cores), NVIDIA's H100 SXM figures.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "demo", "outputs", "synthetic_room",
                     "synthetic_room.off")
TEST_YAML = os.path.join(ROOT, "configs", "iscnet_test.yaml")
DETECTION_YAML = os.path.join(ROOT, "configs", "iscnet_detection.yaml")
SEED = 0
TRAIN_BATCH = 8  # train.batch_size of configs/iscnet.yaml
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over reps, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its milliseconds from CUDA events): for a plain version,
    timed on the call that is compared with its kernel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mesh_comparable(a, b, iso: float = 0.0, margin: float = 1e-3):
    """Whether marching cubes over two versions of one proposal's logit
    grid (numpy, from two devices) must give the same faces: the values
    lie on the same side of `iso` everywhere, and no lattice edge crosses
    it with a value difference under `margin`. Returns (comparable, the
    vertex tolerance in cells): a crossing sits at -va / (vb - va) along
    its edge, which moves by at most the grids' largest difference over
    the smallest crossing difference; the tolerance is twice that."""
    if ((a > iso) != (b > iso)).any():
        return False, None
    gap = float("inf")
    for axis in range(a.ndim):
        lo = a.take(range(a.shape[axis] - 1), axis)
        hi = a.take(range(1, a.shape[axis]), axis)
        cross = (lo > iso) != (hi > iso)
        if cross.any():
            gap = min(gap, float(abs(lo - hi)[cross].min()))
    if gap < margin:
        return False, None
    return True, 2.0 * float(abs(a - b).max()) / gap


def vertex_error_ratio(a, b, grid_a, grid_b, padding: float = 0.1,
                       iso: float = 0.0) -> float:
    """For the meshes a and b that marching cubes made from two versions of
    one proposal's logit grid (numpy, n^3, from two devices) lying on the
    same side of `iso` everywhere (so their faces are equal): the largest
    ratio of a vertex's distance between a and b to its tolerance. A
    vertex sits on a lattice edge at t = (iso - va) / (vb - va) of b's
    values; when every value moves by at most d (the grids' largest
    difference), t moves by at most d (|va - iso| + |vb - iso|) /
    (vb - va)^2 to first order, and the tolerance is twice that (and
    1e-9 cells). A ratio over 1 fails."""
    import numpy as np

    n = grid_b.shape[0]
    box = 1.0 + padding
    cell = box / (n - 1)
    d = float(np.abs(grid_a - grid_b).max())
    padded = np.pad(grid_b.astype(np.float64), 1, constant_values=-1e6)
    idx = (b.vertices + box / 2) / cell + 1.0  # padded index space
    near = np.round(idx)
    on_axis = np.abs(idx - near) > 1e-9  # the edge's axis
    lo = np.where(on_axis, np.floor(idx), near).astype(np.int64)
    hi = lo + on_axis
    va = padded[lo[:, 0], lo[:, 1], lo[:, 2]] - iso
    vb = padded[hi[:, 0], hi[:, 1], hi[:, 2]] - iso
    gap = np.where(on_axis.any(1), np.abs(vb - va), np.inf)
    tol = (2 * d * (np.abs(va) + np.abs(vb)) / gap ** 2 + 1e-9) * cell
    dist = np.abs(a.vertices - b.vertices).max(axis=1)
    return float((dist / tol).max()) if len(dist) else 0.0


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def slice_setup(dev):
    """The main path's inputs: the test config, the 80000-point demo scene
    and the model with seeded weights, on `dev`."""
    from rfdnet_tpu_torch import config, demo, weights

    cfg = config.TEST_CONFIG
    data = demo.load_demo_data(SCENE, num_points=cfg["data"]["num_point"],
                               device=dev)
    model = weights.init_seeded(config.build_model(cfg, device=dev), SEED)
    return cfg, data, model


def phase_device():
    smi = nvidia_smi()
    print(smi, flush=True)
    from rfdnet_tpu_torch.ops import _native, fps

    # always from the sources: the compiler's report comes only from a build
    shutil.rmtree(_native.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _native.build()
    build_s = round(time.perf_counter() - t0, 3)
    ptxas = {name: _native.ptxas_summary(log) for name, log in logs.items()}
    resident = fps_resident_ptxas(ptxas["fps"])
    emit(phase="device", nvidia_smi=smi, build_s=build_s, ptxas=ptxas,
         fps_resident=resident)
    check(all(r["spill"] == [0, 0] for r in ptxas["cbn_decoder_bf16"]),
          f"cbn_decoder_bf16 spills: {ptxas['cbn_decoder_bf16']}")
    for route in fps.RESIDENT_ROUTES:
        rows = [r for r in resident if not r["stub"]
                and (r["clustered"], r["threads"], r["ppt"])
                == (route.cluster > 1, route.threads, route.ppt)]
        check(len(rows) == 1, f"{route}: {len(rows)} ptxas rows, expected 1")
        check(rows[0]["spill"] == [0, 0], f"{route} spills: {rows[0]}")


def fps_resident_ptxas(rows):
    """The `ptxas` rows of the resident FPS kernel's instantiations, with
    the template arguments read from the mangled name: registers a
    thread, spills, static shared memory (`smem`) and the dynamic shared
    memory a launch gives it (`smem_dynamic`, the CTA's points)."""
    out = []
    for row in rows:
        m = re.search(r"fps_residentILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                      row["kernel"])
        if m:
            t, p, c, stub = (int(g) for g in m.groups())
            out.append(dict(threads=t, ppt=p, clustered=bool(c),
                            stub=bool(stub), registers=row["registers"],
                            spill=row["spill"], smem=row.get("smem"),
                            smem_dynamic=t * p * 12))
    return out


def fps_inputs(xyz, votes=None):
    """The FPS inputs of the paths: SA1-4 (each sampling the previous
    layer's samples), seed_fps over the 1024 seeds (main path and demo),
    and with `votes`, vote_fps over the scene's 1024 votes (detection
    path)."""
    from rfdnet_tpu_torch.ops import furthest_point_sample, gather_points

    shapes = [(2048, "sa1"), (1024, "sa2"), (512, "sa3"), (256, "sa4")]
    out, cur = [], xyz
    for npoint, name in shapes:
        out.append((name, cur, npoint))
        cur = gather_points(cur, furthest_point_sample(cur, npoint)).contiguous()
        if name == "sa2":
            seeds = cur
    out.append(("seed_fps", seeds, 256))
    if votes is not None:
        out.append(("vote_fps", votes, 256))
    return out


def fps_edge_inputs(xyz, dev):
    """FPS inputs beside the main path's, each (name, points, npoint):
    the shapes and data where a resident kernel can go wrong."""
    from rfdnet_tpu_torch.ops import fps

    g = torch.Generator().manual_seed(SEED + 2)

    def uniform(b, n):
        return (torch.rand(b, n, 3, generator=g) * 4 - 2).to(dev)

    n = xyz.shape[1]
    two = torch.cat([xyz, xyz.flip(1) * 0.5 + 0.25]).contiguous()
    out = [(f"batch2_{n}", two, 256)]
    for route in fps.RESIDENT_ROUTES:  # the last cap + 1 goes to streaming
        for size in (route.capacity, route.capacity + 1):
            out.append((f"switch_{size}", uniform(1, size), 48))
    for size in (3000, 20000):  # one CTA, and a cluster
        block = uniform(2, size)
        block[:, 1:size // 4] *= 1e-3   # never candidates, index 1 too
        out.append((f"near_origin_block_{size}", block, 300))
        out.append((f"near_origin_all_{size}", uniform(1, size) * 1e-3, 40))
    out.append(("npoint_over_n", uniform(2, 100), 160))
    return out


def phase_fps(xyz, votes, reps: int = 3, sa1_repeats: int = 5):
    from rfdnet_tpu_torch.ops.fps import (STREAMING_ROUTE, fps_plain,
                                          fps_route, furthest_point_sample,
                                          launch_route)

    rows = []
    for name, pts, npoint in fps_inputs(xyz, votes):
        N, steps = pts.shape[1], npoint - 1
        route = fps_route(N)
        p = fps_plain(pts, npoint)
        # a lost barrier or a slot reused a step early shows only sometimes
        ks = [furthest_point_sample(pts, npoint)
              for _ in range(sa1_repeats if name == "sa1" else 1)]
        # the one-CTA kernel that served these shapes before the resident one
        ks.append(launch_route(pts, npoint, STREAMING_ROUTE))
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(k, p)) for k in ks)
        # per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        b, by = bound_ms(N * 12 + npoint * 4, 10.0 * N * steps, F32_FLOPS)
        ms = cuda_ms(lambda: furthest_point_sample(pts, npoint), reps)
        stub_ms = chain_bound_ms(pts, npoint, route, reps)
        rows.append(dict(
            name=name, n=N, npoint=npoint, equal=equal, compared=len(ks),
            max_abs_err=max(int((k.long() - p.long()).abs().max())
                            for k in ks),
            route=dataclasses.asdict(route),
            ms=ms, us_per_step=ms * 1e3 / steps,
            prev_ms=cuda_ms(lambda: launch_route(pts, npoint,
                                                 STREAMING_ROUTE), reps),
            plain_ms=cuda_ms(lambda: fps_plain(pts, npoint), 1, 0),
            bound_ms=b, bound_by=by, chain_bound_ms=stub_ms,
            stub_us_per_step=stub_ms * 1e3 / steps,
        ))
        check(equal, f"fps {name}: kernel indices differ from the plain version")
    edges = []
    for name, pts, npoint in fps_edge_inputs(xyz, xyz.device):
        route = fps_route(pts.shape[1])
        k = furthest_point_sample(pts, npoint)
        equal = bool(torch.equal(k, fps_plain(pts, npoint)))
        edges.append(dict(name=name, b=pts.shape[0], n=pts.shape[1],
                          npoint=npoint, equal=equal,
                          route=dataclasses.asdict(route)))
        check(equal, f"fps {name}: kernel indices differ from the plain version")
    check(any(e["route"]["kind"] == "streaming" for e in edges),
          "fps: no edge shape reached the streaming kernel")
    batch_rows = fps_batch_rows(xyz, TRAIN_BATCH, reps)
    flag_off = fps_flag_off_rows(xyz, reps)
    emit(phase="fps", shapes=rows, edges=edges, batch_shapes=batch_rows,
         flag_off=flag_off)
    return rows, batch_rows, flag_off


def fps_batch_rows(xyz, b: int, reps: int = 3):
    """The five FPS shapes of a train step (SA1-4, seed_fps) at batch b:
    b scenes, the cloud scaled by 1 + 0.01 i for scene i. Each row: its
    route, how many of the route's clusters the card runs at once
    (`active_clusters`; b scenes need b), indices equal to `fps_plain`,
    kernel ms, bound, plain ms."""
    from rfdnet_tpu_torch.ops.fps import (active_clusters, fps_plain,
                                          fps_route, furthest_point_sample)

    scale = 1 + 0.01 * torch.arange(b, device=xyz.device)[:, None, None]
    rows = []
    for name, pts, npoint in fps_inputs((xyz * scale).contiguous()):
        N, steps = pts.shape[1], npoint - 1
        route = fps_route(N, b)
        k = furthest_point_sample(pts, npoint)
        p = fps_plain(pts, npoint)
        equal = bool(torch.equal(k, p))
        bnd, by = bound_ms(b * (N * 12 + npoint * 4), 10.0 * b * N * steps,
                           F32_FLOPS)
        rows.append(dict(
            name=name, b=b, n=N, npoint=npoint, equal=equal,
            max_abs_err=int((k.long() - p.long()).abs().max()),
            route=dataclasses.asdict(route),
            active_clusters=active_clusters(route, b),
            ms=cuda_ms(lambda: furthest_point_sample(pts, npoint), reps),
            plain_ms=cuda_ms(lambda: fps_plain(pts, npoint), 1, 0),
            bound_ms=bnd, bound_by=by,
            chain_bound_ms=chain_bound_ms(pts, npoint, route, reps)))
        check(equal, f"fps {name} at batch {b}: kernel indices differ from "
              "the plain version")
    return rows


def chain_bound_ms(pts, npoint: int, route, reps: int = 3,
                   skip_near_origin: bool = True) -> float:
    """The least time a chain of npoint - 1 dependent steps takes on a
    resident route at this batch: the route's stub kernel (its reductions,
    barriers and exchange, no point work) timed on `pts`."""
    from rfdnet_tpu_torch.ops.fps import FpsRoute, launch_route

    stub = FpsRoute("resident", route.cluster, route.threads, 1)
    return cuda_ms(lambda: launch_route(pts, npoint, stub, stub=True,
                                        skip_near_origin=skip_near_origin),
                   reps)


def fps_flag_off_rows(xyz, reps: int = 3):
    """The kernel with `skip_near_origin=False` against `fps_plain` with
    the same flag, indices equal: SA1's 80000 -> 2048 at batch 1 and at
    batch 8 (the clouds of `fps_batch_rows`) and one slab of
    `parallel.halo.fps_bucketed` (the scene's first quarter in x order at
    4 ranks -> `local_budget` samples), each timed, with its launches and
    bound; then clouds near the origin at each route (one CTA, a cluster,
    batch 8, streaming), where the flag changes the selection: a block of
    a quarter of the points within 2e-3 of the origin, index 1 among them
    (indices equal to the plain version's), and every point there (and
    also the kernel's flag-on indices differ from its flag-off ones)."""
    from rfdnet_tpu_torch.ops.fps import (RESIDENT_ROUTES, fps_plain,
                                          fps_route, furthest_point_sample)
    from rfdnet_tpu_torch.parallel.halo import local_budget, slab_sort

    b = TRAIN_BATCH
    scale = 1 + 0.01 * torch.arange(b, device=xyz.device)[:, None, None]
    n_slab = xyz.shape[1] // 4
    timed = [("sa1", xyz, 2048), (f"sa1_b{b}", (xyz * scale).contiguous(), 2048),
             (f"slab_{n_slab}", slab_sort(xyz)[0][:, :n_slab].contiguous(),
              local_budget(2048, 4, 4, n_slab))]
    rows = []
    for name, pts, npoint in timed:
        B, N, steps = pts.shape[0], pts.shape[1], npoint - 1
        reset_launches()
        k = furthest_point_sample(pts, npoint, skip_near_origin=False)
        launches = read_launches()["fps"]
        p = fps_plain(pts, npoint, skip_near_origin=False)
        bnd, by = bound_ms(B * (N * 12 + npoint * 4), 10.0 * B * N * steps,
                           F32_FLOPS)
        rows.append(dict(
            name=name, b=B, n=N, npoint=npoint, launches=launches,
            equal=bool(torch.equal(k, p)),
            max_abs_err=int((k.long() - p.long()).abs().max()),
            route=dataclasses.asdict(fps_route(N, B)),
            ms=cuda_ms(lambda: furthest_point_sample(
                pts, npoint, skip_near_origin=False), reps),
            ms_flag_on=cuda_ms(lambda: furthest_point_sample(pts, npoint),
                               reps),
            plain_ms=cuda_ms(lambda: fps_plain(
                pts, npoint, skip_near_origin=False), 1, 0),
            bound_ms=bnd, bound_by=by,
            chain_bound_ms=chain_bound_ms(pts, npoint, fps_route(N, B), reps,
                                          skip_near_origin=False)))
        check(rows[-1]["equal"] and launches == 1,
              f"fps flag off {name}: {rows[-1]}")
    g = torch.Generator().manual_seed(SEED + 4)
    edges = []
    for B, N in ((1, 3000), (1, 20000), (b, 20000),
                 (1, RESIDENT_ROUTES[-1].capacity + 1)):
        pts = torch.rand(B, N, 3, generator=g) * 4 - 2
        block = pts.clone()
        block[:, 1:N // 4] *= 1e-3
        for kind, cloud, npoint in (("block", block, 300),
                                    ("all", pts * 1e-3, 40)):
            cloud = cloud.to(xyz.device).contiguous()
            off = furthest_point_sample(cloud, npoint, skip_near_origin=False)
            on = furthest_point_sample(cloud, npoint)
            edges.append(dict(
                name=f"near_origin_{kind}_{N}" + (f"_b{B}" if B > 1 else ""),
                b=B, n=N, npoint=npoint,
                route=dataclasses.asdict(fps_route(N, B)),
                equal=bool(torch.equal(off, fps_plain(
                    cloud, npoint, skip_near_origin=False))),
                differs_from_flag_on=not bool(torch.equal(off, on))))
            check(edges[-1]["equal"] and (kind == "block" or edges[-1][
                "differs_from_flag_on"]), f"fps flag off: {edges[-1]}")
    check({e["route"]["kind"] for e in edges} == {"resident", "streaming"},
          "fps flag off: a route not reached")
    return dict(rows=rows, edges=edges)


def library_chain(h0, sc, sh, w0s, b0s, w1s, b1s, w_out, b_out, dtype):
    """The decode chain with each 256x256 product one cuBLAS call in the
    working dtype (bf16 tensor cores in the bf16 mode): the yardstick."""
    h = h0.to(dtype)
    sc, sh = sc.to(dtype)[:, :, None, :], sh.to(dtype)[:, :, None, :]
    w0, w1 = w0s.to(dtype), w1s.to(dtype)
    for i in range(5):
        t = torch.relu(h * sc[:, 2 * i] + sh[:, 2 * i])
        t = torch.relu((t @ w0[i] + b0s[i].to(dtype)) * sc[:, 2 * i + 1]
                       + sh[:, 2 * i + 1])
        h = h + (t @ w1[i] + b1s[i].to(dtype))
    hf = torch.relu(h * sc[:, 10] + sh[:, 10]).float()
    return hf @ w_out + b_out


def decoder_operands(model, nb: int, res: int, dev):
    """The fused decoder's operands for nb proposals over the res^3 grid,
    as `ONet.decode_fused` builds them, with seeded conditioning codes."""
    from rfdnet_tpu_torch.models.occnet import make_3d_grid

    onet = model.completion
    g = torch.Generator().manual_seed(SEED + 1)
    c = (torch.randn(nb, 512, generator=g) * 0.5).to(dev)
    pts = 1.1 * make_3d_grid((-0.5,) * 3, (0.5,) * 3, (res,) * 3, device=dev)
    z = torch.zeros(nb, onet.z_dim, device=dev)
    with torch.no_grad():
        return onet.fused_operands(pts[None].expand(nb, -1, -1), z, c)


# the rounding mistakes a bf16 kernel could make at its epilogues, which
# `plain_f64_sums(mistake=)` makes on purpose: each affine's product not
# rounded before its add (an FMA), each matmul rounded to bf16 before its
# f32 bias as well as after it, the carry h left unrounded after its add
BF16_MISTAKES = ("fused_affine", "rounded_before_bias", "carry_f32")


def plain_f64_sums(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                   mistake=None):
    """`cbn_decode_plain(..., mxu_dtype=bfloat16)` with each product summed
    in f64 before its f32 bias: the same chain, rounded at the same
    points, each f32 sum of exact bf16 products correctly rounded, so it
    does not depend on an order of summation. The bf16 kernel is held to
    it. `mistake`: one of BF16_MISTAKES, made on purpose (a control that
    the bf16 checks must fail)."""
    def q(t):
        return t.to(torch.bfloat16).float()

    def keep(t):
        return t

    qp = keep if mistake == "fused_affine" else q
    qb = q if mistake == "rounded_before_bias" else keep
    qh = keep if mistake == "carry_f32" else q
    h = q(h0.float())
    sc, sh = q(scales)[:, :, None, :], q(shifts)[:, :, None, :]
    w0, w1 = q(w0s).double(), q(w1s).double()

    def affine_relu(x, row):
        return torch.relu(q(qp(x * sc[:, row]) + sh[:, row]))

    for i in range(5):
        t = affine_relu(h, 2 * i)
        t = q(qb((t.double() @ w0[i]).float()) + b0s[i])
        t = affine_relu(t, 2 * i + 1)
        t = q(qb((t.double() @ w1[i]).float()) + b1s[i])
        h = qh(h + t)
    return (affine_relu(h, 10) * w_out).sum(-1) + b_out.reshape(())


# A bf16 output "differs" from the exact-sum chain's when it is over 1e-5
# x scale away. The bf16 kernel may differ on at most this share of the
# outputs: a fixed limit between the readings of sound chains that sum in
# other orders and those of the controls (`plain_f64_sums(mistake=)`, the
# f32 chain), which every row checks still land above it. Read on an
# H100 at the nine shapes of the paths: the kernel 0.0073-0.84 %, cuBLAS's
# f32 sums 0.0043-0.47 %, the controls 41.3-99.4 % (PERF.md, section 6).
BF16_DIFFER_SHARE = 0.05
# where the last bf16 rows of each path land (`cbn_row` in bf16), by name
CBN_BF16_ROWS = {}


def differ_share(a, b, scale: float) -> float:
    return float(((a - b).abs() > 1e-5 * scale).float().mean())


def cbn_row(ops, dtype=torch.float32, reps: int = 3, points=None,
            chunk=None) -> dict:
    """The CBN kernel against its plain version on `ops` (the operands of
    `fused_cbn_decode`) in one operand type: error, tolerance, times of
    the kernel, the plain version and the cuBLAS chain, and the bound, of
    `points` points (the real ones of a padded decode; all when None).
    With `chunk`, the plain versions and the chain run over that many
    proposals at a time (a decode too large for them in one go; the
    proposals are independent), their times summed over the chunks.

    f32 (csrc/cbn_decoder.cu): against `cbn_decode_plain`, the same math;
    tolerance 1e-4 x scale. It sums each product in cuBLAS's order (read:
    1.2e-7 at scale 1).

    bf16 (csrc/cbn_decoder_bf16.cu, timed as the path calls it: h0 in
    bf16, the weights' slab image made once): the kernel and the plain
    version round at the same points, but wherever two orders of an f32
    sum fall on two sides of a bf16 rounding the chain carries the flip,
    so the kernel is held to the plain chain with exact sums
    (`plain_f64_sums`), not to one order of cuBLAS's: `max_abs_err` below
    the kernel's distance to the plain f32 chain (`err_vs_plain_f32`),
    and at most BF16_DIFFER_SHARE of the outputs differing from it
    (`differ_share`), while every control (`mistake_differ_share`,
    `plain_f32_differ_share`) differs on more. A limit of 1e-3 x scale
    on `max_abs_err` is not checked: one flip that the chain carries
    moves an output by more, and cuBLAS's own order misses it against
    the exact sums at most shapes (`plain_order_spread`, up to 3.1e-3 at
    scale 1 on an H100); `within_1e3_scale` reports it. Reported beside
    them: the kernel against `cbn_decode_plain(bf16)`
    (`err_vs_plain_cublas`) and that plain chain against the exact one
    (`plain_order_spread`, `plain_differ_share`)."""
    from rfdnet_tpu_torch.ops.cbn_decoder import (
        bf16_weight_image,
        cbn_decode_plain,
        fused_cbn_decode,
    )

    bf16 = dtype == torch.bfloat16
    nb, T = ops[0].shape[0], ops[0].shape[1]
    points = nb * T if points is None else points
    chunk = chunk or nb
    parts = [(ops[0][i:i + chunk], ops[1][i:i + chunk], ops[2][i:i + chunk],
              *ops[3:]) for i in range(0, nb, chunk)]
    kw = dict(mxu_dtype=dtype)
    if bf16:  # as `FusedDecoder` hands them over
        kw["w_image"] = bf16_weight_image(ops[3], ops[5])
        ops = (ops[0].to(torch.bfloat16), *ops[1:])
    k = fused_cbn_decode(*ops, **kw)
    p = torch.cat([cbn_decode_plain(*part, mxu_dtype=dtype)
                   for part in parts])
    torch.cuda.synchronize()
    b, by = bound_ms(points * 256 * (2 if bf16 else 4) + points * 4,
                     2.0 * points * 10 * 256 * 256,
                     BF16_FLOPS if bf16 else F32_FLOPS)
    row = dict(
        nb=nb, t=T, points=points, out=k,
        ms=cuda_ms(lambda: fused_cbn_decode(*ops, **kw), reps),
        plain_ms=sum(cuda_ms(lambda: cbn_decode_plain(
            *part, mxu_dtype=dtype), 1) for part in parts),
        library_ms=sum(cuda_ms(lambda: library_chain(*part, dtype), reps)
                       for part in parts),
        bound_ms=b, bound_by=by)
    if not bf16:
        scale = max(float(p.abs().max()), 1.0)
        row.update(max_abs_err=float((k - p).abs().max()), tol=1e-4 * scale,
                   scale=scale)
        return row
    exact = torch.cat([plain_f64_sums(*part) for part in parts])
    f32 = torch.cat([cbn_decode_plain(*part) for part in parts])
    scale = max(float(exact.abs().max()), 1.0)
    mistakes = {m: differ_share(torch.cat([plain_f64_sums(
        *part, mistake=m) for part in parts]), exact, scale)
        for m in BF16_MISTAKES}
    err = float((k - exact).abs().max())
    row.update(max_abs_err=err, scale=scale,
               within_1e3_scale=err <= 1e-3 * scale,
               err_vs_plain_f32=float((k - f32).abs().max()),
               err_vs_plain_cublas=float((k - p).abs().max()),
               plain_order_spread=float((p - exact).abs().max()),
               differ_share=differ_share(k, exact, scale),
               plain_differ_share=differ_share(p, exact, scale),
               mistake_differ_share=mistakes,
               plain_f32_differ_share=differ_share(f32, exact, scale))
    return row


def check_cbn_row(row: dict, what: str) -> None:
    """`cbn_row`'s checks (see there) of a row that has left its `out`."""
    if "differ_share" in row:
        controls = [*row["mistake_differ_share"].values(),
                    row["plain_f32_differ_share"]]
        ok = (row["max_abs_err"] < row["err_vs_plain_f32"]
              and row["differ_share"] <= BF16_DIFFER_SHARE < min(controls))
    else:
        ok = row["max_abs_err"] <= row["tol"]
    check(ok, f"cbn_decode {what}: kernel vs plain {row}")


def bf16_row(name: str, ops, **kw) -> dict:
    """The bf16 kernel's `cbn_row` on `ops` (a path's captured operands),
    checked and kept in CBN_BF16_ROWS under `name`."""
    row = cbn_row(ops, torch.bfloat16, **kw)
    row.pop("out")
    check_cbn_row(row, f"bf16 at {name}")
    CBN_BF16_ROWS[name] = row
    return row


def phase_cbn(model, dev, nb: int = 64, res: int = 32, reps: int = 3):
    from rfdnet_tpu_torch.ops.cbn_decoder import cbn_decode_plain, fused_cbn_decode

    ops = decoder_operands(model, nb, res, dev)
    T = res ** 3
    rows = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        row = rows[dname] = cbn_row(ops, dtype, reps)
        row.pop("out")
        check_cbn_row(row, dname)
    CBN_BF16_ROWS["grid_t32768"] = rows["bfloat16"]
    # a T that is no multiple of either kernel's tile (64 f32, 128 bf16)
    ragged = decoder_operands(model, 3, 10, dev)
    err = float((fused_cbn_decode(*ragged) - cbn_decode_plain(*ragged))
                .abs().max())
    check(err <= 1e-4, f"cbn_decode at T=1000: kernel vs plain max err {err}")
    ragged_bf16 = bf16_row("ragged_t1000", ragged)
    emit(phase="cbn_decode", nb=nb, t=T, modes=rows, ragged_t1000_err=err,
         ragged_t1000_bf16=ragged_bf16)
    return rows


# the kernels a path shows in `read_launches` only where it launched them
OPTIONAL_LAUNCHES = ("cbn_decode_bf16", "render_depth", "tsdf_fuse",
                     "adam")


# each kernel's launch counter (`utils.profiling.count`)
LAUNCH_COUNTERS = {"fps": "ops.fps.launches",
                   "cbn_decode": "ops.cbn_decode.launches",
                   "cbn_decode_bf16": "ops.cbn_decode.launches_bf16",
                   "render_depth": "ops.render_depth.launches",
                   "tsdf_fuse": "ops.tsdf_fuse.launches",
                   "adam": "ops.adam.launches"}
# the recording the launch counts come from: open from the first
# `launch_recorder()` call to the end of the process
_LAUNCH_RECORDING = contextlib.ExitStack()
_launch_state = {"recorder": None, "base": {}}


def launch_recorder():
    """The recorder that counts the kernels' launches, opened at its first
    call (`main` calls it first) and left open."""
    if _launch_state["recorder"] is None:
        from rfdnet_tpu_torch.utils import profiling

        _launch_state["recorder"] = _LAUNCH_RECORDING.enter_context(
            profiling.recording())
        atexit.register(_LAUNCH_RECORDING.close)
    return _launch_state["recorder"]


def reset_launches() -> None:
    rec = launch_recorder()
    _launch_state["base"] = {k: rec.counter(c)
                             for k, c in LAUNCH_COUNTERS.items()}


def read_launches() -> dict:
    """The launches since `reset_launches`: FPS, the CBN decoder (both
    kernels), and, when there were any, those of the bf16 kernel
    (`cbn_decode_bf16`) and of the prep's raster and fusion
    (`render_depth`, `tsdf_fuse`), so that a path's counts read as before
    and a launch of one of those on a path that should not make it fails
    its check."""
    rec, base = launch_recorder(), _launch_state["base"]
    counts = {k: rec.counter(c) - base.get(k, 0)
              for k, c in LAUNCH_COUNTERS.items()}
    for name in OPTIONAL_LAUNCHES:
        if not counts[name]:
            del counts[name]
    return counts


def launches_between(before: dict, after: dict) -> dict:
    """The launches from one `read_launches` to a later one, with the
    optional kernels' only where they launched."""
    diff = {k: after[k] - before.get(k, 0) for k in after}
    for name in OPTIONAL_LAUNCHES:
        if not diff.get(name):
            diff.pop(name, None)
    return diff


def part_timer():
    """(seconds, lap): `lap(name)` records under `name` in `seconds` the
    host-clock seconds since the previous lap (or this call)."""
    seconds, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 3)
        last[0] = now

    return seconds, lap


def spread(values) -> dict:
    return {"mean": sum(values) / len(values), "min": min(values),
            "max": max(values)}


def span_ms(tables: list, key: str) -> dict:
    """{span name: spread over the calls' `recording()` tables of each
    call's `key` ("device_ms" or "host_ms")}, for the spans every call
    opened and that have it."""
    names = set.intersection(*(set(t) for t in tables))
    return {name: spread([t[name][key] for t in tables]) for name in
            sorted(names) if all(t[name][key] is not None for t in tables)}


def span_means(rec) -> dict:
    """{span name: calls, and the mean device and host ms a call} of a
    recorder's table."""
    out = {}
    for name, row in rec.table()["spans"].items():
        n = row["calls"]
        out[name] = {"calls": n, "host_ms": row["host_ms"] / n,
                     "device_ms": None if row["device_ms"] is None
                     else row["device_ms"] / n}
    return out


def timed_scenes(run_scene, scenes: int) -> dict:
    """One warm-up call of run_scene(), then `scenes` timed calls one at
    a time (as the test protocol runs them), each in a `recording()` of
    its own and each ending in a synchronise. Returns the window and
    single-scene times on the host clock, the device ms (`stage_ms`) and
    host ms (`host_stage_ms`) of each span the calls opened, and the
    first timed call's launch counts and result."""
    from rfdnet_tpu_torch.utils import profiling

    run_scene()  # warm-up
    torch.cuda.synchronize()
    walls, recorders = [], []
    t_window = time.perf_counter()
    for i in range(scenes):
        if i == 0:
            reset_launches()
        with profiling.recording() as rec:
            t0 = time.perf_counter()
            out = run_scene()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        recorders.append(rec)
        if i == 0:
            launches, first = read_launches(), out
    window = (time.perf_counter() - t_window) * 1e3
    tables = [rec.table()["spans"] for rec in recorders]
    return dict(
        wall_ms=window / scenes, wall_ms_min=min(walls),
        wall_ms_max=max(walls), stage_ms=span_ms(tables, "device_ms"),
        host_stage_ms=span_ms(tables, "host_ms"),
        launches=launches, first=first)


def phase_slice(model, data, cfg, scenes: int = 10):
    """The main path twice: to the grids on the card (`generate_grids`),
    and on to the meshes on the host (`generate`, with one generator over
    the scenes). The outputs checked are those of
    each run's first timed scene. Returns the launches of both runs and
    the grids, valid flags and meshes for the `mesh` phase."""
    from rfdnet_tpu_torch import demo
    from rfdnet_tpu_torch.meshing.native import mesh_threads

    pc = data["point_clouds"]
    to_grids = timed_scenes(
        lambda: demo.generate_grids(cfg, model, pc), scenes)
    _, parsed, gen, grids = to_grids.pop("first")

    generator = demo.make_generator(cfg, model)
    to_meshes = timed_scenes(
        lambda: demo.generate(cfg, model, data, generator=generator), scenes)
    parsed_m, gen_m, meshes = to_meshes.pop("first")
    stage_mesh = dict(to_meshes["stage_ms"])
    for name in ("demo.d2h", "demo.mesh"):
        stage_mesh[name] = to_meshes["host_stage_ms"][name]
    triangles = sum(len(m.faces) for m in meshes)
    res = cfg["generation"]["resolution_0"]
    emit(phase="slice", points=int(pc.shape[1]),
         proposals=int(parsed["obj_prob"].shape[1]),
         grids=list(grids.shape), finite=bool(torch.isfinite(grids).all()),
         pred_mask=int(parsed["pred_mask"].sum()),
         valid=int(gen["valid"].sum()), scenes=scenes,
         wall_ms=to_grids["wall_ms"], wall_ms_min=to_grids["wall_ms_min"],
         wall_ms_max=to_grids["wall_ms_max"], stage_ms=to_grids["stage_ms"],
         launches=to_grids["launches"],
         wall_mesh_ms=to_meshes["wall_ms"],
         wall_mesh_ms_min=to_meshes["wall_ms_min"],
         wall_mesh_ms_max=to_meshes["wall_ms_max"],
         stage_mesh_ms=stage_mesh, launches_mesh=to_meshes["launches"],
         mesh_threads=mesh_threads(len(meshes)), triangles=triangles,
         vertices=sum(len(m.vertices) for m in meshes),
         meshes_non_empty=sum(len(m.faces) > 0 for m in meshes))
    check(tuple(grids.shape) == (model.generate_limit, res, res, res),
          f"grids shape {tuple(grids.shape)}")
    check(bool(torch.isfinite(grids).all()), "non-finite grid logits")
    for what, run in (("to the grids", to_grids),
                      ("to the meshes", to_meshes)):
        check(run["launches"] == {"fps": 5, "cbn_decode": 1},
              f"kernel launches on the main path {what}: {run['launches']}")
    check(bool((gen_m["valid"] == gen["valid"].cpu().numpy()).all())
          and bool((parsed_m["pred_mask"]
                    == parsed["pred_mask"].cpu().numpy()).all()),
          "generate and generate_grids disagree on the selected proposals")
    check(len(meshes) == model.generate_limit and triangles > 0,
          f"{len(meshes)} meshes with {triangles} triangles")
    return ({"main": to_grids["launches"], "mesh": to_meshes["launches"]},
            grids.cpu().numpy(), gen_m["valid"].reshape(-1), meshes)


MESH_OPTIONS = {"refinement_step": 30, "simplify_nfaces": 5000,
                "with_normals": True}
# refine on the card against the CPU (same draws): vertices, and normals
REFINE_ATOL, NORMAL_ATOL = 1e-5, 1e-4


def phase_mesh_options(model, data, scenes: int = 2):
    """`Generator3D`'s options at full width: the test config with
    `MESH_OPTIONS` through `demo.generate` on the demo scene (a warm-up,
    then `scenes` timed scenes): the latency split into grid decode,
    extraction, simplify, refine and normals; triangles before and after
    simplify; refine's first and last loss; unit normals; the launches.
    Then marching tetrahedra on the same grids, and refine and normals on
    a 4096-point scene on the card against the CPU."""
    import numpy as np

    from rfdnet_tpu_torch import config, demo
    from rfdnet_tpu_torch.meshing.generator import Generator3D

    cfg = config.load_config(TEST_YAML, mode="test")
    cfg["generation"].update(MESH_OPTIONS)
    gen = demo.make_generator(cfg, model)
    runs = []

    def scene():
        out = demo.generate(cfg, model, data, generator=gen)
        runs.append(dict(gen.last_ms, losses=gen.refine_losses))
        return out

    res = timed_scenes(scene, scenes)
    parsed, out_gen, meshes = res.pop("first")
    runs = runs[1:]
    valid = out_gen["valid"].reshape(-1)
    # the same scene's grids, extracted without the options
    grids = demo.generate_grids(cfg, model, data["point_clouds"])[3]
    grids = grids.cpu().numpy()
    plain = Generator3D(None).meshes_from_grids(grids, valid)
    before = sum(len(m.faces) for m in plain)
    after = sum(len(m.faces) for m in meshes)
    norms = [np.linalg.norm(m.vertex_normals, axis=1) for m in meshes
             if len(m.vertices)]
    norm_err = max(float(np.abs(n - 1).max()) for n in norms)
    t0 = time.perf_counter()
    tetra = Generator3D(None, extractor="marching_tetrahedra"
                        ).meshes_from_grids(grids, valid)
    tetra_ms = (time.perf_counter() - t0) * 1e3
    tetra_triangles = sum(len(m.faces) for m in tetra)
    stage = {k: spread([r[k] for r in runs]) for k in (
        "extract", "simplify", "refine", "normals")}
    for name in ("demo.d2h", "demo.mesh"):
        stage[name] = res["host_stage_ms"][name]
    reference = mesh_options_reference(model, cfg)
    emit(phase="mesh_options", options=MESH_OPTIONS, scenes=scenes,
         valid=int(valid.sum()), wall_ms=res["wall_ms"],
         wall_ms_min=res["wall_ms_min"], wall_ms_max=res["wall_ms_max"],
         device_stage_ms=res["stage_ms"], host_stage_ms=stage,
         triangles_before_simplify=before, triangles_after_simplify=after,
         refine_loss=[r["losses"] for r in runs], normal_norm_err=norm_err,
         launches=res["launches"], marching_tetrahedra=dict(
             triangles=tetra_triangles, ms=tetra_ms,
             open_edges=closed_meshes(tetra),
             marching_cubes_triangles=before),
         reference=reference)
    check(res["launches"] == {"fps": 5, "cbn_decode": 1},
          f"mesh_options: launches {res['launches']}")
    check(0 < after < before and all(
        len(m.faces) < len(p.faces) for m, p in zip(meshes, plain)
        if len(p.faces) > MESH_OPTIONS["simplify_nfaces"]),
        f"mesh_options: {before} triangles, {after} after simplify")
    check(all(np.isfinite(r["losses"]).all() for r in runs),
          "mesh_options: refine's loss is not finite")
    check(norm_err <= 1e-5, f"mesh_options: normals off unit by {norm_err}")
    check(tetra_triangles > before and closed_meshes(tetra) == 0,
          f"mesh_options: marching tetrahedra {tetra_triangles} triangles")
    return res["launches"]


def mesh_options_reference(model, cfg, num_points: int = 4096,
                           meshes: int = 3, faces: int = 1000) -> dict:
    """Refine (30 steps, the same draws) and normals of `meshes` meshes of
    a `num_points`-point scene, simplified to about `faces` faces, on the
    card and on the CPU from the same base meshes and codes: vertices
    within REFINE_ATOL, normals within NORMAL_ATOL."""
    import copy

    import numpy as np

    from rfdnet_tpu_torch import demo
    from rfdnet_tpu_torch.meshing.generator import Generator3D, dirichlet_draws
    from rfdnet_tpu_torch.meshing.mesh import TriMesh
    from rfdnet_tpu_torch.meshing.native import simplify_mesh

    data = demo.load_demo_data(SCENE, num_points=num_points,
                               device=next(model.parameters()).device)
    _, _, gen, grids = demo.generate_grids(cfg, model, data["point_clouds"])
    valid = gen["valid"].reshape(-1).cpu().numpy()
    base = Generator3D(None).meshes_from_grids(grids.cpu().numpy(), valid)
    rows = [i for i, m in enumerate(base) if len(m.faces)][:meshes]
    picked = [TriMesh(*simplify_mesh(base[i].vertices, base[i].faces, faces,
                                     5.0)) for i in rows]
    steps = MESH_OPTIONS["refinement_step"]
    eps = dirichlet_draws(steps, max(len(m.faces) for m in picked))[:, None]
    cpu_model = copy.deepcopy(model).to("cpu")
    out = {}
    for name, m in (("card", model), ("cpu", cpu_model)):
        d = next(m.parameters()).device
        f, c = gen["features"].to(d), gen["cls_codes"].to(d)
        g = Generator3D(None)
        decode = m.gradient_decoder(f, c)
        refined = g.refine_meshes(picked, rows, decode, steps, eps=eps,
                                  device=d)
        normals = g.estimate_normals([r.vertices for r in refined], rows,
                                     decode, d)
        out[name] = (refined, normals, g.refine_losses)
    vert_err = max(float(np.abs(a.vertices - b.vertices).max())
                   for a, b in zip(out["card"][0], out["cpu"][0]))
    normal_err = max(float(np.abs(a - b).max())
                     for a, b in zip(out["card"][1], out["cpu"][1]))
    moved = max(float(np.abs(a.vertices - b.vertices).max())
                for a, b in zip(out["card"][0], picked))
    check(vert_err <= REFINE_ATOL,
          f"mesh_options reference: refined vertices {vert_err} apart")
    check(normal_err <= NORMAL_ATOL,
          f"mesh_options reference: normals {normal_err} apart")
    check(moved > 0, "mesh_options reference: refine moved nothing")
    return dict(points=num_points, meshes=len(picked),
                faces=[len(m.faces) for m in picked], steps=steps,
                vertex_err=vert_err, normal_err=normal_err, moved=moved,
                losses={k: v[2] for k, v in out.items()})


def phase_modules(model, data, scenes: int = 3):
    """The modules no config selects, on the card: `SetAbstractionMSG` at
    SA1's shape (80000 -> 2048, radii 0.1 and 0.2) against the CPU (FPS
    indices equal, ball-query indices compared, features of the centers
    whose groups agree within f32 tolerance); then the full-width scene
    to the grids with `data.mlp_bf16` against f32, in turns, and the bf16
    run's launches."""
    import copy

    from rfdnet_tpu_torch import config, demo, weights
    from rfdnet_tpu_torch.models import SetAbstractionMSG
    from rfdnet_tpu_torch.ops import ball_query

    dev = next(model.parameters()).device
    pc = data["point_clouds"]
    msg = weights.init_seeded(SetAbstractionMSG(
        2048, (0.1, 0.2), (16, 32), 1, ((32, 32, 64), (64, 64, 128))),
        SEED).to(dev).eval()
    xyz, feats = pc[..., :3].contiguous(), pc[..., 3:4].contiguous()
    with torch.no_grad():
        reset_launches()
        new_xyz, new_feat, inds = msg(xyz, feats)
        msg_launches = read_launches()
        msg_ms = cuda_ms(lambda: msg(xyz, feats), reps=3)
        cpu = copy.deepcopy(msg).to("cpu")
        c_xyz, c_feat, c_inds = cpu(xyz.cpu(), feats.cpu())
        agree = torch.ones(new_xyz.shape[1], dtype=torch.bool)
        for r, ns in zip(msg.radii, msg.nsamples):
            agree &= (ball_query(xyz, new_xyz, r, ns).cpu()
                      == ball_query(xyz.cpu(), c_xyz, r, ns)).all(-1)[0]
    got, want = new_feat.cpu()[0, agree], c_feat[0, agree]
    feat_err = float((got - want).abs().max())
    feat_ok = bool(torch.allclose(got, want, atol=3e-5, rtol=2e-4))

    bf16_cfg = copy.deepcopy(config.TEST_CONFIG)
    bf16_cfg["data"]["mlp_bf16"] = True
    bf16 = weights.init_seeded(config.build_model(bf16_cfg, device=dev), SEED)
    runs = {}
    for name, m in (("f32", model), ("bf16", bf16), ("bf16_2", bf16),
                    ("f32_2", model)):
        runs[name] = timed_scenes(lambda m=m: demo.generate_grids(
            config.TEST_CONFIG, m, pc), scenes)
    g32, g16 = runs["f32"].pop("first")[3], runs["bf16"].pop("first")[3]
    for r in runs.values():
        r.pop("first", None)
    emit(phase="modules", msg=dict(
        shape=[int(xyz.shape[1]), 2048], radii=list(msg.radii),
        nsamples=list(msg.nsamples), features=int(new_feat.shape[-1]),
        ms=msg_ms, launches=msg_launches,
        indices_equal=bool(torch.equal(inds.cpu(), c_inds)),
        groups_agree=int(agree.sum()), feature_err=feat_err),
         mlp_bf16={name: dict(wall_ms=r["wall_ms"], wall_ms_min=r[
             "wall_ms_min"], wall_ms_max=r["wall_ms_max"],
             stage_ms=r["stage_ms"], launches=r["launches"])
             for name, r in runs.items()},
         bf16_grid_max_diff=float((g16 - g32).abs().max()),
         bf16_finite=bool(torch.isfinite(g16).all()))
    check(torch.equal(inds.cpu(), c_inds),
          "modules: SetAbstractionMSG's FPS indices differ from the CPU's")
    check(agree.float().mean() > 0.99 and feat_ok,
          f"modules: SetAbstractionMSG features {feat_err} apart on "
          f"{int(agree.sum())} agreeing groups")
    check(msg_launches == {"fps": 1, "cbn_decode": 0},
          f"modules: SetAbstractionMSG launches {msg_launches}")
    check(bool(torch.isfinite(g16).all()), "modules: bf16 grids not finite")
    check(runs["bf16"]["launches"] == {"fps": 5, "cbn_decode": 1},
          f"modules: mlp_bf16 launches {runs['bf16']['launches']}")
    return {"msg": msg_launches, "mlp_bf16": runs["bf16"]["launches"]}


def meshes_equal(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.vertices, y.vertices)
        and np.array_equal(x.faces, y.faces) for x, y in zip(a, b))


def phase_mesh(model, cfg, grids, valid, meshes):
    """Checks of the full-width scene's meshes (see the module docstring).
    The -1e6 pad closes every surface, so every edge has two faces."""
    import numpy as np

    from rfdnet_tpu_torch import demo
    from rfdnet_tpu_torch.meshing.native import (marching_cubes_batch,
                                                 mesh_threads)

    generator = demo.make_generator(cfg, model)
    res = grids.shape[1]
    # the pad's crossing lies within 1e-6 of a cell beyond the outer lattice
    limit = 0.5 * (1 + generator.padding) + 1e-4
    open_edges = outside = 0
    for m in meshes:
        if len(m.faces) == 0:
            continue
        f = m.faces.astype(np.int64)
        edges = np.sort(np.concatenate(
            [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges[:, 0] * len(m.vertices) + edges[:, 1],
                              return_counts=True)
        open_edges += int((counts != 2).sum())
        outside += int((np.abs(m.vertices) > limit).any(axis=1).sum())
    again = generator.meshes_from_grids(grids, valid=valid)
    # both routes, whatever this machine's core count makes the default
    # (the batch call alone, beside each route, says how much of a route's
    # time is the extractor and how much the Python around it; each is
    # timed twice in a row, since the first call after a change of the
    # thread count finds the allocator cold)
    saved = os.environ.get("RFDNET_MESH_THREADS")
    routes, route_ms, native_ms = {}, {}, {}
    try:
        for name, threads in (("per_proposal_1", 1), ("batch_4", 4),
                              ("batch_8", 8)):
            os.environ["RFDNET_MESH_THREADS"] = str(threads)
            check(mesh_threads(len(grids)) == threads, "mesh: thread count")
            route_ms[name], native_ms[name] = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                routes[name] = generator.meshes_from_grids(grids, valid=valid)
                route_ms[name].append((time.perf_counter() - t0) * 1e3)
            for _ in range(2):
                t0 = time.perf_counter()
                marching_cubes_batch(grids, generator.iso, valid=valid)
                native_ms[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        if saved is None:
            del os.environ["RFDNET_MESH_THREADS"]
        else:
            os.environ["RFDNET_MESH_THREADS"] = saved
    identical = {name: meshes_equal(got, meshes)
                 for name, got in routes.items()}
    emit(phase="mesh", meshes=len(meshes), resolution=res,
         open_edges=open_edges, vertices_outside=outside,
         repeat_identical=meshes_equal(again, meshes),
         routes_identical=identical, route_ms=route_ms,
         batch_call_ms=native_ms)
    check(open_edges == 0, f"mesh: {open_edges} edges without two faces")
    check(outside == 0, f"mesh: {outside} vertices outside the padded box")
    check(meshes_equal(again, meshes), "mesh: a second extraction differs")
    check(all(identical.values()),
          f"mesh: a route's arrays differ from the scene's: {identical}")


def phase_reference(model, cfg, num_points: int = 4096):
    """The whole path on a small input on the card and on the CPU (plain
    versions), same weights. Index outputs are exact: the FPS chain's
    sampling indices, the NMS keep mask, the selected proposal ids and
    their valid flags. Detection floats use atol 3e-5, rtol 2e-4 (cuBLAS
    and the CPU sum in other orders); the skip-propagation features and
    the grids, ~30 chained layers on, atol 1e-4 * max(scale, 1), rtol
    1e-3. Meshes: `demo.generate` on the card against the extraction of
    the CPU's grids, for the proposals that `mesh_comparable` passes:
    faces equal, vertices within its tolerance."""
    import copy

    import numpy as np

    from rfdnet_tpu_torch import demo

    dev = next(model.parameters()).device
    data = demo.load_demo_data(SCENE, num_points=num_points, device=dev)
    pc = data["point_clouds"]
    ep, parsed, gen, grids = demo.generate_grids(cfg, model, pc)
    cpu_model = copy.deepcopy(model).to("cpu")
    pc_c = pc.cpu()
    ep_c, parsed_c, gen_c, grids_c = demo.generate_grids(cfg, cpu_model, pc_c)
    errs = {}

    def equal(name, got, want):
        check(torch.equal(got.cpu(), want), f"reference {name} differ")

    def close(name, got, want, atol, rtol):
        got, want = got.detach().cpu().double(), want.detach().double()
        errs[name] = float((got - want).abs().max())
        check(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
              f"reference {name}: max err {errs[name]}")

    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds"):
        equal(k, ep[k], ep_c[k])
    for k in ("sa1_features", "fp2_features", "vote_xyz", "center",
              "objectness_scores", "sem_cls_scores"):
        close(k, ep[k], ep_c[k], 3e-5, 2e-4)
    close("obj_prob", parsed["obj_prob"], parsed_c["obj_prob"], 3e-5, 2e-4)
    equal("pred_mask", parsed["pred_mask"], parsed_c["pred_mask"])
    equal("proposal_ids", gen["proposal_ids"], gen_c["proposal_ids"])
    equal("valid", gen["valid"], gen_c["valid"])
    close("features", gen["features"], gen_c["features"],
          1e-4 * max(float(gen_c["features"].abs().max()), 1.0), 1e-3)
    close("grids", grids, grids_c,
          1e-4 * max(float(grids_c.abs().max()), 1.0), 1e-3)

    generator = demo.make_generator(cfg, cpu_model)
    valid = gen_c["valid"].reshape(-1).numpy()
    _, gen_m, meshes = demo.generate(cfg, model, data)
    check(bool((gen_m["valid"].reshape(-1) == valid).all()),
          "reference: generate selects other proposals than generate_grids")
    check(meshes_equal(meshes, generator.meshes_from_grids(
        grids.cpu().numpy(), valid=valid)),
        "reference: the meshes of generate differ from the extraction of "
        "generate_grids' grids")
    meshes_c = generator.meshes_from_grids(grids_c.numpy(), valid=valid)
    cell = (1 + generator.padding) / (grids.shape[1] - 1)
    g_np, gc_np = grids.cpu().numpy(), grids_c.numpy()
    compared = left_out = 0
    vert_err = vert_tol = 0.0
    for g in np.flatnonzero(valid):
        ok, tol_cells = mesh_comparable(g_np[g], gc_np[g], generator.iso)
        if not ok:
            left_out += 1
            continue
        compared += 1
        a, b = meshes[g], meshes_c[g]
        check(np.array_equal(a.faces, b.faces),
              f"reference: faces of slot {g} differ")
        err = float(np.abs(a.vertices - b.vertices).max()) if len(
            a.vertices) else 0.0
        vert_err, vert_tol = max(vert_err, err), max(vert_tol,
                                                     tol_cells * cell)
        check(err <= tol_cells * cell + 1e-12,
              f"reference: vertices of slot {g} differ by {err}, over "
              f"{tol_cells * cell}")
    emit(phase="reference", points=num_points, max_abs_err=errs,
         pred_mask=int(parsed_c["pred_mask"].sum()),
         valid=int(gen_c["valid"].sum()), meshes_compared=compared,
         meshes_left_out_near_iso=left_out, mesh_vertex_max_err=vert_err,
         mesh_vertex_tol=vert_tol,
         triangles=sum(len(m.faces) for m in meshes))
    check(compared > 0, "reference: no proposal's meshes could be compared")
    return errs


MISE_STEPS = 2  # Occupancy Networks' generation setting (resolution_0 32)


def mise_config(tmp: str, pairs=()) -> str:
    """A copy of the test config with `upsampling_steps: 2` and this
    script's seed (and `pairs`, each (old, new) once), under `tmp`."""
    return config_copy(TEST_YAML, os.path.join(tmp, "iscnet_mise.yaml"), [
        ("\nseed: 10\n", f"\nseed: {SEED}\n", 1),
        ("upsampling_steps: 0", f"upsampling_steps: {MISE_STEPS}", 1),
        *((old, new, 1) for old, new in pairs)])


def closed_meshes(meshes) -> int:
    """Edges, over `meshes`, that are not shared by exactly two faces."""
    import numpy as np

    open_edges = 0
    for m in meshes:
        if len(m.faces) == 0:
            continue
        f = np.asarray(m.faces, np.int64)
        edges = np.sort(np.concatenate(
            [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges[:, 0] * len(m.vertices) + edges[:, 1],
                              return_counts=True)
        open_edges += int((counts != 2).sum())
    return open_edges


def octree_active_sets(out, nb: int, steps: int):
    """{(proposal, level): sorted active voxel ids} of a `MiseOutput`."""
    import numpy as np

    counts = out.level_counts.cpu().numpy()
    idx = out.idx.cpu().numpy()
    sets, k = {}, 0
    for i in range(nb):
        for l in range(steps):
            sets[i, l] = idx[k:k + counts[i, l]].tolist()
            k += counts[i, l]
    return sets


def oracle_active_sets(trees, res0: int, steps: int):
    """The same of the Python `MISE` oracles' values (NaN where unknown):
    each level's mixed-sign voxels with 8 known corners."""
    import numpy as np

    sets = {}
    for i, tree in enumerate(trees):
        for l in range(steps):
            s, n = 2 ** (steps - l), res0 * 2 ** l
            v = tree.values[::s, ::s, ::s]
            occ = sum((np.nan_to_num(v[dx:n + dx, dy:n + dy, dz:n + dz],
                                     nan=-np.inf) >= tree.threshold)
                      .astype(int) for dx in (0, 1) for dy in (0, 1)
                      for dz in (0, 1))
            known = sum((~np.isnan(v[dx:n + dx, dy:n + dy, dz:n + dz]))
                        .astype(int) for dx in (0, 1) for dy in (0, 1)
                        for dz in (0, 1))
            act = (occ > 0) & (occ < 8) & (known == 8)
            sets[i, l] = np.flatnonzero(act.reshape(-1)).tolist()
    return sets


def host_octrees(generator, features, cls_codes, oracle: bool):
    """The host route's grids (`Generator3D.mise_grids`, decodes on the
    card) with the C++ octrees, or with the Python oracles, returned too."""
    from rfdnet_tpu_torch.meshing import mise

    if not oracle:
        return generator.mise_grids(features, cls_codes), None
    trees, make = [], mise._make_tree
    mise._make_tree = lambda *a: trees.append(mise.MISE(*a)) or trees[-1]
    try:
        return generator.mise_grids(features, cls_codes), trees
    finally:
        mise._make_tree = make


def mise_reference(cfg, model, num_points: int = 4096) -> dict:
    """A 4096-point scene on the card against the CPU (same weights):
    sampling indices, proposals and valid flags equal, the octrees' active
    counts a level equal, meshes equal where `mesh_comparable` allows; and
    with `use_sampling` (one z a proposal from `ISCNet.sample_z`, the same
    draw on both devices) the dense grids within atol 1e-4 x max(scale,
    1), rtol 1e-3, away from the prior-mean grids."""
    import copy

    import numpy as np

    from rfdnet_tpu_torch import demo
    from rfdnet_tpu_torch.meshing.mise_device import reconstruct_dense

    dev = next(model.parameters()).device
    pc = demo.load_demo_data(SCENE, num_points=num_points,
                             device=dev)["point_clouds"]
    cpu_model = copy.deepcopy(model).to("cpu")
    runs = {name: demo.generate_grids(cfg, m, x)
            for name, m, x in (("card", model, pc),
                               ("cpu", cpu_model, pc.cpu()))}
    (ep, parsed, gen, out), (ep_c, parsed_c, gen_c, out_c) = (
        runs["card"], runs["cpu"])
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds"):
        check(torch.equal(ep[k].cpu(), ep_c[k]), f"mise reference: {k}")
    for k in ("proposal_ids", "valid"):
        check(torch.equal(gen[k].cpu(), gen_c[k]), f"mise reference: {k}")
    counts = [[lv["active"] for lv in o.levels[1:]] for o in (out, out_c)]
    check(counts[0] == counts[1],
          f"mise reference: active voxels a level {counts}")
    res0 = cfg["generation"]["resolution_0"]
    grids = [reconstruct_dense(o.lvl0, o.idx, o.vals, o.level_counts, res0,
                               MISE_STEPS).cpu().numpy() for o in (out, out_c)]
    generator = demo.make_generator(cfg, cpu_model)
    valid = gen_c["valid"].reshape(-1).numpy()
    meshes = [generator.meshes_from({k: getattr(o, k).cpu().numpy() for k in (
        "lvl0", "idx", "vals", "level_counts")}, valid=valid)
        for o in (out, out_c)]
    # at R = 128 a crossing edge with a small value difference is in every
    # grid, so `mesh_comparable`'s margin would leave every mesh out: the
    # vertices are held to a tolerance of their own edge
    compared = left_out = 0
    worst = 0.0
    for g in np.flatnonzero(valid):
        if ((grids[0][g] > 0) != (grids[1][g] > 0)).any():
            left_out += 1
            continue
        compared += 1
        a, b = meshes[0][g], meshes[1][g]
        check(np.array_equal(a.faces, b.faces),
              f"mise reference: faces of slot {g}")
        worst = max(worst, vertex_error_ratio(a, b, grids[0][g],
                                              grids[1][g]))
    check(compared > 0 and worst <= 1.0,
          f"mise reference: {compared} meshes compared, vertices at "
          f"{worst} of their tolerance")
    # the sampled z, on the dense route
    sampled = copy.deepcopy(cfg)
    sampled["generation"].update(upsampling_steps=0, use_sampling=True)
    prior = copy.deepcopy(sampled)
    prior["generation"]["use_sampling"] = False
    sg = [demo.generate_grids(sampled, m, x)
          for m, x in ((model, pc), (cpu_model, pc.cpu()))]
    check(torch.equal(sg[0][2]["proposal_ids"].cpu(), sg[1][2]["proposal_ids"])
          and torch.equal(sg[0][2]["valid"].cpu(), sg[1][2]["valid"]),
          "mise reference: sampled z, proposals differ")
    got, want = sg[0][3].cpu().double(), sg[1][3].double()
    scale = max(float(want.abs().max()), 1.0)
    sample_err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-4 * scale + 1e-3 * want.abs())
               .all()), f"mise reference: sampled grids differ by "
          f"{sample_err}")
    # the prior-mean grids from the card's run (held to the CPU's by the
    # `reference` and `tester` phases): one full-width decode on the CPU less
    off_prior = float((demo.generate_grids(prior, model, pc)[3].cpu()
                       .double() - want).abs().max())
    check(off_prior > 1e-3 * scale, "mise reference: the sampled z moved "
          f"the grids by only {off_prior}")
    return dict(points=num_points, valid=int(valid.sum()),
                active=counts[0], meshes_compared=compared,
                meshes_left_out_near_iso=left_out,
                vertex_err_of_tolerance=worst,
                grid_err=float(max(np.abs(grids[0][g] - grids[1][g]).max()
                                   for g in np.flatnonzero(valid))),
                sampled_grid_err=sample_err, sampled_off_prior=off_prior)


def phase_mise(model, data, scenes: int = 3, reps: int = 3):
    """MISE at full width (see the module docstring). Returns (launches
    of one scene, the CBN kernel's rows at the level shapes)."""
    import numpy as np

    import rfdnet_tpu_torch.models.occnet as occnet
    from rfdnet_tpu_torch import cli, config, demo
    from rfdnet_tpu_torch.meshing.mesh import TriMesh
    from rfdnet_tpu_torch.meshing.mise_device import reconstruct_dense

    cwd = os.getcwd()
    seconds, lap = part_timer()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = mise_config(tmp)
        cfg = config.load_config(cfg_path, mode="demo")
        res0 = cfg["generation"]["resolution_0"]
        generator = demo.make_generator(cfg, model)
        scene_levels = []

        def scene():
            out = demo.generate(cfg, model, data, generator=generator)
            scene_levels.append(generator.octree_levels)
            return out

        run = timed_scenes(scene, scenes)
        lap("scenes")
        parsed, gen, meshes = run.pop("first")
        levels = scene_levels[1]  # the first timed scene's
        level_launches = sum(lv["launches"] for lv in levels)
        # the octree once more, its decodes captured: the card's octree
        # against the host's, the replay against dense marching cubes
        captured, launch = [], occnet.fused_cbn_decode

        def capture(*ops, **kw):
            captured.append(ops)
            return launch(*ops, **kw)

        occnet.fused_cbn_decode = capture
        try:
            _, _, out, octree = demo.generate_grids(cfg, model,
                                                    data["point_clouds"])
        finally:
            occnet.fused_cbn_decode = launch
        feats, codes = out["features"], out["cls_codes"]
        valid = out["valid"].reshape(-1)
        dense = reconstruct_dense(octree.lvl0, octree.idx, octree.vals,
                                  octree.level_counts, res0,
                                  MISE_STEPS).cpu().numpy()
        host = {k: getattr(octree, k).cpu().numpy()
                for k in ("lvl0", "idx", "vals", "level_counts")}
        v_np = valid.cpu().numpy()
        replay = generator.meshes_from(host, valid=v_np)
        replay_identical = meshes_equal(
            replay, generator.meshes_from_grids(dense, valid=v_np))
        device_sets = octree_active_sets(octree, len(v_np), MISE_STEPS)
        del octree
        host_gen = demo.make_generator(cfg, model, mise_impl="host")
        t0 = time.perf_counter()
        host_grids, _ = host_octrees(host_gen, feats, codes, oracle=False)
        host_ms = (time.perf_counter() - t0) * 1e3
        oracle_grids, trees = host_octrees(host_gen, feats, codes,
                                           oracle=True)
        oracle_sets = oracle_active_sets(trees, res0, MISE_STEPS)
        del trees
        vg = np.flatnonzero(v_np)
        grid_err = float(np.abs(dense[vg] - host_grids[vg]).max())
        sets_equal = all(device_sets[g, l] == oracle_sets[g, l]
                         for g in vg for l in range(MISE_STEPS))
        lap("octrees")
        # the decoder at each level's shape
        check(len(captured) == level_launches,
              f"mise: {len(captured)} decodes captured, {levels}")
        cbn, n = {}, 0
        for level, lv in enumerate(levels):
            for chunk in range(lv["launches"]):
                # the real points of a one-launch level; else the padded
                row = cbn[f"level{level}_{chunk}"] = cbn_row(
                    captured[n], reps=reps,
                    points=lv["points"] if lv["launches"] == 1 else None)
                row.pop("out")
                row.update(level=level, launches=1)
                check(row["max_abs_err"] <= row["tol"],
                      f"mise: cbn_decode at level {level}: kernel vs plain "
                      f"max err {row['max_abs_err']} > {row['tol']}")
                bf16_row(f"mise_level{level}_{chunk}", captured[n],
                         reps=reps, points=row["points"]).update(
                    level=level, launches=0)
                n += 1
        del captured
        torch.cuda.empty_cache()
        lap("cbn_rows")
        triangles = sum(len(m.faces) for m in meshes)
        emit(phase="mise", resolution_0=res0, upsampling_steps=MISE_STEPS,
             points=int(data["point_clouds"].shape[1]),
             valid=int(gen["valid"].sum()), scenes=scenes,
             wall_mesh_ms=run["wall_ms"], wall_mesh_ms_min=run["wall_ms_min"],
             wall_mesh_ms_max=run["wall_ms_max"], stage_ms=run["stage_ms"],
             download_ms=run["host_stage_ms"]["demo.d2h"],
             host_mc_ms=run["host_stage_ms"]["demo.mesh"],
             levels=levels, launches=run["launches"], triangles=triangles,
             open_edges=closed_meshes(meshes),
             replay_identical=replay_identical,
             host_octree_ms=host_ms, host_grid_err=grid_err,
             oracle_grids_identical=bool(np.array_equal(oracle_grids[vg],
                                                        host_grids[vg])),
             active_sets_equal=sets_equal, cbn_decode=cbn)
        check(run["launches"] == {"fps": 5, "cbn_decode": level_launches},
              f"mise: launches {run['launches']}, levels {levels}")
        check(all(lv["launches"] >= 1 for lv in levels),
              f"mise: a level without a decode: {levels}")
        check(triangles > 0 and closed_meshes(meshes) == 0,
              "mise: meshes empty or not closed")
        check(replay_identical,
              "mise: the sparse replay differs from dense marching cubes")
        check(sets_equal, "mise: active sets of the card's octree differ "
              "from the host's")
        check(grid_err <= 1e-5 * max(float(np.abs(host_grids[vg]).max()),
                                     1.0),
              f"mise: the card's grids differ from the host's by {grid_err}")
        check(np.array_equal(oracle_grids[vg], host_grids[vg]),
              "mise: the Python and C++ octrees differ")
        emit(phase="mise_reference", **mise_reference(cfg, model))
        lap("reference")
        # the CLI in demo mode on the copy
        os.chdir(tmp)
        try:
            reset_launches()
            t0 = time.perf_counter()
            out_dir = os.path.abspath(cli.main([
                "--config", cfg_path, "--mode", "demo",
                "--demo_path", SCENE]))
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            demo_launches = read_launches()
            plys = [TriMesh.load(os.path.join(out_dir, f))
                    for f in sorted(os.listdir(out_dir))
                    if f.startswith("proposal_")]
        finally:
            os.chdir(cwd)
    lap("cli_demo")
    emit(phase="mise_demo", cli_s=demo_s, launches=demo_launches,
         mesh_files=len(plys), open_edges=closed_meshes(plys),
         triangles=sum(len(m.faces) for m in plys), phase_seconds=seconds)
    check(len(plys) > 0 and closed_meshes(plys) == 0,
          "mise: the CLI demo's meshes missing or not closed")
    check(demo_launches == run["launches"],
          f"mise: launches of the CLI demo {demo_launches}")
    return run["launches"], cbn


class Tee:
    """A stdout that also keeps what is written (`text()`)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_logged(fn):
    """fn() with stdout kept: (its result, what it printed)."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn()
    return out, tee.text()


def html_counts(path: str) -> dict:
    """The element counts embedded in a `scene.html`: points, mesh
    vertices (3 a triangle) and box line ends (24 a box), of each scene."""
    with open(path) as f:
        html = f.read()
    check(os.path.getsize(path) > 0, f"{path} is empty")
    start = html.index('{"scenes"')
    payload = json.JSONDecoder().raw_decode(html[start:])[0]
    return {name: {k: v["n"] for k, v in scene.items()}
            for name, scene in payload["scenes"].items()}


def check_html(path: str, points: int, triangles: int, what: str) -> dict:
    """`scene.html` holds the scan's points and the dumped meshes' faces,
    and whole boxes."""
    counts = html_counts(path)["scene"]
    check(counts["points"] == points and counts["mesh"] == 3 * triangles
          and counts["box_lines"] % 24 == 0,
          f"{what}: scene.html counts {counts}, expected {points} points "
          f"and {3 * triangles} mesh vertices")
    return counts


def trace_kernels(path: str) -> list:
    """The CUDA kernel names of a Chrome trace, sorted."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if e.get("cat") == "kernel" and "name" in e})


def phase_demo():
    """The CLI in demo mode at full width, in a temporary directory: the
    files of `demo.save_visualization` and `pred.png`, read back, the
    `scene.html` counts against the dumps; then the CLI again with
    `--profile`, whose trace must name both kernels."""
    import numpy as np

    from rfdnet_tpu_torch import cli, config
    from rfdnet_tpu_torch.meshing.mesh import TriMesh

    with open(TEST_YAML) as f:
        text = f.read()
    check(text.count("\nseed: 10\n") == 1, "demo: the config's seed line")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "iscnet_test.yaml")
        with open(cfg_path, "w") as f:
            f.write(text.replace("\nseed: 10\n", f"\nseed: {SEED}\n"))
        points = config.load_config(cfg_path)["data"]["num_point"]
        os.chdir(tmp)
        try:
            reset_launches()
            t0 = time.perf_counter()
            out_dir, printed = run_logged(lambda: cli.main([
                "--config", cfg_path, "--mode", "demo", "--demo_path",
                SCENE]))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_launches()
            out_dir = os.path.abspath(out_dir)
            files = sorted(os.listdir(out_dir))
            png_bytes = os.path.getsize(os.path.join(out_dir, "pred.png"))
            bbox = np.load(os.path.join(
                out_dir, "000000_pred_confident_nms_bbox.npz"))
            obbs, proposal_map = bbox["obbs"], bbox["proposal_map"]
            scan = TriMesh.load(os.path.join(out_dir, "000000_pc.ply"))
            plys = [f for f in files if f.startswith("proposal_")]
            triangles, finite = 0, True
            for name in plys:
                mesh = TriMesh.load(os.path.join(out_dir, name))
                triangles += len(mesh.faces)
                finite = finite and bool(np.isfinite(mesh.vertices).all())
            html = check_html(os.path.join(out_dir, "scene.html"),
                              len(scan.vertices), triangles, "demo")
            check(html["box_lines"] == 24 * len(obbs),
                  f"demo: scene.html boxes {html}, {len(obbs)} in the npz")
            # the same run traced
            t0 = time.perf_counter()
            cli.main(["--config", cfg_path, "--mode", "demo", "--demo_path",
                      SCENE, "--profile", os.path.join(tmp, "profile")])
            profile_s = time.perf_counter() - t0
            trace = os.path.join(tmp, "profile", "trace.json")
            trace_bytes = os.path.getsize(trace)
            kernels = trace_kernels(trace)
        finally:
            os.chdir(cwd)
    ids = {int(name.split("_")[1]) for name in plys}
    traced = {k: [n for n in kernels if k in n] for k in (
        "fps_resident", "cbn_decode_kernel")}
    emit(phase="demo", wall_s=wall_s, launches=launches, files=len(files),
         mesh_files=len(plys), boxes=list(obbs.shape),
         proposal_map=list(proposal_map.shape),
         scan_vertices=len(scan.vertices), triangles=triangles,
         scene_html=html, pred_png_bytes=png_bytes, profile_s=profile_s,
         trace_bytes=trace_bytes, trace_kernels=len(kernels),
         traced=traced)
    check("export failed" not in printed, "demo: an export failed")
    check(png_bytes > 0, "demo: empty pred.png")
    check(all(traced.values()),
          f"demo --profile: the trace names no kernel of {traced}")
    k = obbs.shape[0]
    check(k > 0 and obbs.shape == (k, 7) and proposal_map.shape == (k, 1),
          f"demo: obbs {obbs.shape}, proposal_map {proposal_map.shape}")
    check(bool(np.isfinite(obbs).all()), "demo: non-finite boxes")
    check(len(scan.vertices) == points and len(scan.faces) == 0,
          f"demo: the scan's PLY holds {len(scan.vertices)} vertices")
    check(len(files) == 4 + len(plys) and "scene.html" in files
          and "pred.png" in files, f"demo: unexpected files {files}")
    check(0 < len(plys) <= k and ids <= set(proposal_map[:, 0].tolist()),
          f"demo: {len(plys)} mesh files for {k} boxes")
    check(triangles > 0 and finite, "demo: empty or non-finite meshes")
    check(launches == {"fps": 5, "cbn_decode": 1},
          f"kernel launches of the demo: {launches}")
    return launches


def phase_detection(dev, scenes: int = 3, num_points: int = 4096):
    """`configs/iscnet_detection.yaml` in demo mode (phase detection,
    `vote_fps`): full width with stage times, then a 4096-point scene on
    the card against the CPU."""
    import copy

    from rfdnet_tpu_torch import config, demo, weights

    cfg = config.load_config(DETECTION_YAML, mode="demo")
    check(cfg["data"]["cluster_sampling"] == "vote_fps",
          "detection: the config's sampling")
    model = weights.init_seeded(config.build_model(cfg, device=dev), SEED)
    pc = demo.load_demo_data(SCENE, num_points=cfg["data"]["num_point"],
                             device=dev)["point_clouds"]
    run = timed_scenes(lambda: demo.generate_grids(cfg, model, pc), scenes)
    ep, parsed, gen, grids = run.pop("first")
    small = demo.load_demo_data(SCENE, num_points=num_points,
                                device=dev)["point_clouds"]
    ep_s, parsed_s, _, _ = demo.generate_grids(cfg, model, small)
    ep_c, parsed_c, _, _ = demo.generate_grids(
        cfg, copy.deepcopy(model).to("cpu"), small.cpu())
    inds = ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds")
    inds_equal = all(torch.equal(ep_s[k].cpu(), ep_c[k]) for k in inds)
    mask_equal = torch.equal(parsed_s["pred_mask"].cpu(),
                             parsed_c["pred_mask"])
    obj_err = float((parsed_s["obj_prob"].cpu() - parsed_c["obj_prob"])
                    .abs().max())
    emit(phase="detection", points=int(pc.shape[1]),
         phase_of_model=model.phase,
         proposals=int(parsed["obj_prob"].shape[1]),
         pred_mask=int(parsed["pred_mask"].sum()), scenes=scenes,
         launches=run["launches"], **{k: run[k] for k in (
             "wall_ms", "wall_ms_min", "wall_ms_max", "stage_ms")},
         reference_points=num_points, reference_inds_equal=inds_equal,
         reference_pred_mask_equal=mask_equal,
         reference_pred_mask=int(parsed_c["pred_mask"].sum()),
         reference_obj_prob_err=obj_err)
    check(gen is None and grids is None and not hasattr(model, "completion"),
          "detection: the model completes shapes")
    check(bool(torch.isfinite(parsed["pred_corners_3d_upright_camera"]).all())
          and tuple(parsed["pred_mask"].shape) == (1, 256),
          "detection: boxes not finite or mask of another shape")
    check(run["launches"] == {"fps": 5, "cbn_decode": 0},
          f"kernel launches of the detection path: {run['launches']}")
    check(inds_equal, "detection: sampling indices differ from the CPU's")
    check(mask_equal, "detection: NMS keep mask differs from the CPU's")
    check(obj_err <= 3e-5 + 2e-4, f"detection: obj_prob differs by {obj_err}")
    return run["launches"]


TESTER_SCENES = 2
TESTER_MISE_SCENES = 1  # the first of them for the test path with MISE


def tester_config(tmp: str, paths: dict, name: str, pairs=()) -> str:
    """A copy of the test config under `tmp` that reads the scenes of
    `paths`, with this script's seed, the mesh mAP on, and `pairs` (each
    (old, new) once). Returns the copy's path."""
    return config_copy(TEST_YAML, os.path.join(tmp, name), [
        (old, new, 1) for old, new in (
            ("\nseed: 10\n", f"\nseed: {SEED}\n"),
            ("split: datasets/splits/fullscan", f"split: {paths['split']}"),
            ("shapenet_path: datasets/ShapeNetv2_data",
             f"shapenet_path: {paths['shapenet_path']}"),
            ("evaluate_mesh_mAP: false", "evaluate_mesh_mAP: true"),
            *pairs)])


def read_test_dumps(root: str, points: int, objects: int,
                    scenes: int = TESTER_SCENES) -> dict:
    """The Tester's per-scene files of `scenes` scenes under `root`, read
    back and checked."""
    import numpy as np

    from rfdnet_tpu_torch.meshing.mesh import TriMesh

    dirs = sorted(os.listdir(root))
    check(len(dirs) == scenes, f"tester: dumps of {dirs}")
    mesh_files = triangles = html_files = 0
    for scene in dirs:
        d = os.path.join(root, scene)
        files = os.listdir(d)
        for name in ("000000_pc.ply", "000000_pred_confident_nms_bbox.ply",
                     "pred_map_cls.txt", "gt_map_cls.txt", "scene.html"):
            check(name in files, f"tester: {scene} has no {name}")
        scan = TriMesh.load(os.path.join(d, "000000_pc.ply"))
        check(len(scan.vertices) == points, f"tester: {scene}'s scan")
        scene_triangles = 0
        with open(os.path.join(d, "gt_map_cls.txt")) as f:
            check(len(f.read().split("\n")) - 1 == objects,
                  f"tester: {scene}'s GT boxes")
        for name in files:
            if name.startswith("proposal_"):
                mesh = TriMesh.load(os.path.join(d, name))
                check(len(mesh.faces) > 0 and bool(np.isfinite(
                    mesh.vertices).all()), f"tester: {scene}/{name}")
                mesh_files += 1
                scene_triangles += len(mesh.faces)
        triangles += scene_triangles
        check_html(os.path.join(d, "scene.html"), points, scene_triangles,
                   f"tester: {scene}")
        html_files += 1
    check(mesh_files > 0, "tester: no mesh written")
    return dict(scenes=len(dirs), mesh_files=mesh_files,
                triangles=triangles, html_files=html_files)


def cli_test(cfg_path: str, cwd: str, scenes: int = TESTER_SCENES):
    """`cli.main --mode test` on `cfg_path` (a split of `scenes` scenes) in
    `cwd`: (metrics, seconds, launches, the dumps read back, open edges of
    the dumped meshes)."""
    from rfdnet_tpu_torch import cli, config
    from rfdnet_tpu_torch.meshing.mesh import TriMesh

    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        reset_launches()
        t0 = time.perf_counter()
        metrics, printed = run_logged(lambda: cli.main([
            "--config", cfg_path, "--mode", "test"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        os.chdir(here)
    check("export failed" not in printed, "tester: an export failed")
    root = os.path.join(cwd, "out", "test", "visualization")
    points = config.load_config(cfg_path, mode="test")["data"]["num_point"]
    dumps = read_test_dumps(root, points, 12, scenes)
    dumps["open_edges"] = closed_meshes(
        TriMesh.load(os.path.join(d, f)) for d, _, files in os.walk(root)
        for f in files if f.startswith("proposal_"))
    return metrics, seconds, launches, dumps


def tester_reference(cfg, model, num_points: int = 4096) -> None:
    """One scene at `num_points` through `ISCNet.generate` with GT fields on
    the card and on the CPU (same weights), then the refit of the CPU's
    meshes on both. Exact: the NMS mask, and the selected proposals with
    their GT ids and classes, up to near-ties: objectness is flat with
    seeded weights and the two devices' values differ by ~1e-7, so two
    proposals whose scores are that close may swap slots, or one may take
    the last slot in place of the other (allowed within 1e-6 of the last
    selected score). Completion and mask loss, when both selected the same
    proposals: rtol 1e-4. Voxel bits of the proposals both selected: equal
    wherever the CPU's logit is over 1e-4 from the iso level. Refit corners
    after 30 steps: within 5e-2, and moved from the predicted boxes. On
    the CPU the two packages agree to 4e-6 for 20 steps, until a chamfer
    match flips on a near-tie; across devices a run read 1.7e-2: the best
    step is picked by a strict `<` on a loss the devices round apart, and
    one Adam step (1e-2 in position and in heading) moves a corner by up
    to 1e-2 x (1 + the box's half-diagonal)."""
    import copy

    import numpy as np

    from rfdnet_tpu_torch import cli, demo
    from rfdnet_tpu_torch.eval.refit import fit_meshes_to_scan
    from rfdnet_tpu_torch.eval.tester import _DEVICE_KEYS
    from rfdnet_tpu_torch.models.occnet import make_3d_grid

    small = copy.deepcopy(cfg)
    small["data"]["num_point"] = num_points
    batch = next(iter(cli._build_loaders(small, ["test"])["test"]))
    cpu_model = copy.deepcopy(model).to("cpu")
    gen_cfg = cfg["generation"]
    outs, slots = {}, {}
    for name, m in (("card", model), ("cpu", cpu_model)):
        dev = next(m.parameters()).device
        out = outs[name] = m.generate(
            {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
             for k in _DEVICE_KEYS}, dump_threshold=gen_cfg["dump_threshold"],
            remove_empty_box=True, decode_grid_res=gen_cfg["resolution_0"])
        ids = out["gen"]["proposal_ids"][0].cpu().numpy()
        valid = out["gen"]["valid"][0].cpu().numpy()
        # proposal -> (slot, GT id, class)
        slots[name] = {int(r[0]): (g, int(r[1]), int(r[2]))
                       for g, r in enumerate(ids) if valid[g]}
    card, cpu = outs["card"], outs["cpu"]
    check(torch.equal(card["parsed"]["pred_mask"].cpu(),
                      cpu["parsed"]["pred_mask"]),
          "tester reference: NMS masks differ")
    probs = cpu["parsed"]["obj_prob"][0].numpy()
    last = min(probs[j] for j in slots["cpu"])
    swapped = set(slots["card"]) ^ set(slots["cpu"])
    common = sorted(set(slots["card"]) & set(slots["cpu"]))
    check(all(abs(probs[j] - last) <= 1e-6 for j in swapped),
          f"tester reference: selections differ beyond near-ties: {swapped}")
    check(all(slots["card"][j][1:] == slots["cpu"][j][1:] for j in common),
          "tester reference: GT ids or classes differ")
    moved_slots = sum(slots["card"][j][0] != slots["cpu"][j][0]
                      for j in common)
    errs = {}
    if not swapped:
        for k, v in (("completion_loss", card["completion_loss"]),
                     ("mask_loss", card["gen"]["mask_loss"])):
            want = cpu[k] if k in cpu else cpu["gen"][k]
            errs[k] = float((v.cpu() - want).abs())
            check(errs[k] <= 1e-4 * max(float(want.abs()), 1.0),
                  f"tester reference: {k} {float(v)} against {float(want)}")
    G = cpu["gen"]["features"].shape[0]
    p16 = make_3d_grid([-0.5 + 1 / 32] * 3, [0.5 - 1 / 32] * 3, (16,) * 3)
    logits = cpu_model.decode_occupancy(cpu["gen"]["features"],
                                        cpu["gen"]["cls_codes"],
                                        p16[None].expand(G, -1, -1)).numpy()
    bits = {name: np.unpackbits(o["shape_voxels_bits"].cpu().numpy(), axis=-1)
            for name, o in outs.items()}
    compared = near = 0
    for j in common:
        gc, gp = slots["card"][j][0], slots["cpu"][j][0]
        far = np.abs(logits[gp]) > 1e-4
        check(bool((bits["card"][gc][far] == bits["cpu"][gp][far]).all()),
              f"tester reference: voxel bits of proposal {j} differ away "
              "from the iso level")
        compared += int(far.sum())
        near += int((~far).sum())
    valid = cpu["gen"]["valid"].reshape(-1).numpy()
    meshes = demo.make_generator(cfg, cpu_model).meshes_from_grids(
        cpu["grids"].numpy(), valid=valid)
    parsed = {k: v.numpy() for k, v in cpu["parsed"].items()}
    refit = [fit_meshes_to_scan(
        dict(parsed), meshes, cpu["gen"]["proposal_ids"].numpy(),
        cpu["gen"]["valid"].numpy(), batch["point_clouds"],
        gen_cfg["dump_threshold"], iterations=30, device=dev)[
            "pred_corners_3d_upright_camera"]
        for dev in (next(model.parameters()).device, "cpu")]
    errs["refit_corners"] = float(np.abs(refit[0] - refit[1]).max())
    moved = float(np.abs(refit[1] - parsed["pred_corners_3d_upright_camera"])
                  .max())
    per_box = np.abs(refit[0] - refit[1]).max(axis=(-2, -1))
    check(errs["refit_corners"] <= 5e-2 and moved > 1e-3,
          f"tester reference: refit corners differ by "
          f"{errs['refit_corners']} (moved {moved})")
    emit(phase="tester_reference", points=num_points,
         selected=len(slots["cpu"]), swapped_near_ties=len(swapped),
         slots_reordered=moved_slots, voxel_bits_compared=compared,
         voxel_bits_near_iso=near, refit_moved=moved,
         refit_boxes_off_by_1e3=int((per_box > 1e-3).sum()),
         refit_boxes=int((np.abs(refit[1] - parsed[
             "pred_corners_3d_upright_camera"]).max(axis=(-2, -1))
                          > 1e-6).sum()), max_abs_err=errs)


def phase_tester(dev, reps: int = 3):
    """The test path (see the module docstring). Returns (launches of one
    scene, the CBN kernel's rows at the two new shapes)."""
    import copy

    import numpy as np

    import rfdnet_tpu_torch.models.occnet as occnet
    from rfdnet_tpu_torch import cli, config
    from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes
    from rfdnet_tpu_torch.eval.tester import Tester

    seconds, lap = part_timer()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_scannet_scenes(os.path.join(tmp, "data"),
                                     TESTER_SCENES, seed=SEED,
                                     num_points=80000, num_objects=12)
        cfg_path = tester_config(tmp, paths, "iscnet_test.yaml")
        metrics, cli_s, launches, dumps = cli_test(cfg_path,
                                                   os.path.join(tmp, "run"))
        lap("cli")
        cfg = config.load_config(cfg_path, mode="test")
        points = cfg["data"]["num_point"]
        model = cli.restore_weights(cfg, config.build_model(cfg, device=dev),
                                    log=lambda m: None)
        # the timed runs without the mesh mAP, as before it was ported
        plain = copy.deepcopy(cfg)
        plain["test"]["evaluate_mesh_mAP"] = False
        tester = Tester(plain, model, log=lambda m: None)
        loader = lambda: cli._build_loaders(cfg, ["test"])["test"]
        # the scene time with a scene in flight and without (no dumps),
        # then once with the mesh mAP
        runs = []
        for overlap, t in ((True, tester), (False, tester),
                           (True, Tester(cfg, model, log=lambda m: None))):
            t.recorder.clear()
            got = t.run(loader(), overlap=overlap)
            runs.append(dict(
                overlap=overlap, mesh_map=t.evaluate_mesh_mAP,
                wall_scene_ms=t.run_ms / TESTER_SCENES,
                stage_ms={k: spread([ms[k] for ms in t.scene_ms])
                          for k in t.scene_ms[0]},
                spans=span_means(t.recorder),
                compute_metrics_ms=t.metrics_ms,
                refit_sizes=t.refit_sizes,
                metrics_max_diff=max(abs(got[k] - metrics[k])
                                     for k in got if k in metrics)))
            check(t.evaluate_mesh_mAP == ("mAP_mesh @0.5" in got),
                  f"tester: metrics of a run {sorted(got)}")
        lap("timed_runs")
        # the decodes of one scene, on the operands the path gives them
        captured, launch = [], occnet.fused_cbn_decode

        def capture(*ops, **kw):
            captured.append(ops)
            return launch(*ops, **kw)

        occnet.fused_cbn_decode = capture
        try:
            tester.test_step(next(iter(loader())))
        finally:
            occnet.fused_cbn_decode = launch
        shapes = [tuple(ops[0].shape[:2]) for ops in captured]
        G = model.generate_limit
        check(shapes == [(G, sum(cfg["data"]["points_subsample"])),
                         (G, 16 ** 3),
                         (G, cfg["generation"]["resolution_0"] ** 3)],
              f"tester: decode shapes {shapes}")
        cbn = {}
        for name, ops in (("loss_t2048", captured[0]),
                          ("voxels_t4096", captured[1])):
            row = cbn[name] = cbn_row(ops, reps=reps)
            row.pop("out")
            check(row["max_abs_err"] <= row["tol"],
                  f"tester: cbn_decode at {name}: kernel vs plain max err "
                  f"{row['max_abs_err']} > {row['tol']}")
            bf16_row(name, ops, reps=reps)
        per_scene = {k: v // TESTER_SCENES for k, v in launches.items()}
        emit(phase="tester", scenes=TESTER_SCENES, points=points,
             cli_s=cli_s, launches=launches, launches_per_scene=per_scene,
             dumps=dumps, metrics={
                 k: v for k, v in metrics.items()
                 if k.startswith(("mAP", "AR")) or "voxel IoU" in k},
             runs=runs, cbn_decode=cbn)
        lap("cbn_rows")
        tester_reference(plain, model)
        lap("reference")
        # the test path with MISE (and the mesh mAP) on the first scenes: a
        # split beside the other, so that its relative entries hold
        first = dict(paths, split=paths["split"] + "_mise")
        os.makedirs(first["split"])
        with open(os.path.join(paths["split"], "scannetv2_val.json")) as f:
            entries = json.load(f)[:TESTER_MISE_SCENES]
        with open(os.path.join(first["split"], "scannetv2_val.json"),
                  "w") as f:
            json.dump(entries, f)
        mise_path = tester_config(tmp, first, "iscnet_test_mise.yaml", [
            ("upsampling_steps: 0", f"upsampling_steps: {MISE_STEPS}")])
        mise_metrics, mise_s, mise_launches, mise_dumps = cli_test(
            mise_path, os.path.join(tmp, "mise"), TESTER_MISE_SCENES)
        lap("cli_mise")
        emit(phase="tester_mise", scenes=TESTER_MISE_SCENES, cli_s=mise_s,
             phase_seconds=seconds,
             launches=mise_launches, dumps=mise_dumps, metrics={
                 k: v for k, v in mise_metrics.items()
                 if k.startswith(("mAP", "AR")) or "voxel IoU" in k})
    check(mise_launches["fps"] == 5 * TESTER_MISE_SCENES
          and mise_launches["cbn_decode"]
          >= (3 + MISE_STEPS) * TESTER_MISE_SCENES,
          f"kernel launches of the test path with MISE: {mise_launches}")
    check(mise_dumps["open_edges"] == 0 and dumps["open_edges"] == 0,
          "tester: dumped meshes not closed")
    check(all(np.isfinite(v) for v in mise_metrics.values())
          and "mAP_mesh @0.5" in mise_metrics,
          f"tester: MISE metrics {sorted(mise_metrics)}")
    check(launches == {"fps": 5 * TESTER_SCENES,
                       "cbn_decode": 3 * TESTER_SCENES},
          f"kernel launches of the test path: {launches}")
    check(all(np.isfinite(v) for v in metrics.values())
          and "mAP @0.5" in metrics and "AR @0.5" in metrics
          and "mAP_mesh @0.5" in metrics and "AR_mesh @0.5" in metrics
          and any(k.endswith("voxel IoU") for k in metrics),
          f"tester: metrics {sorted(metrics)}")
    return per_scene, cbn


TRAIN_YAML = os.path.join(ROOT, "configs", "iscnet.yaml")
COMPLETION_YAML = os.path.join(ROOT, "configs", "iscnet_completion.yaml")
TRAIN_SCENES = 8


def config_copy(src: str, dst: str, pairs) -> str:
    """A copy of the config `src` at `dst` with each (old, new, count) of
    `pairs` replaced (old must occur `count` times). Returns `dst`."""
    with open(src) as f:
        text = f.read()
    for old, new, count in pairs:
        check(text.count(old) == count, f"{src}: the config's line {old!r}")
        text = text.replace(old, new)
    with open(dst, "w") as f:
        f.write(text)
    return dst


def train_pairs(paths: dict, tmp: str, epochs: int):
    """The replacements every training config copy takes: this script's
    seed, the synthetic scenes, `epochs`, runs under `tmp`."""
    return [("\nseed: 10\n", f"\nseed: {SEED}\n", 1),
            ("split: datasets/splits/fullscan", f"split: {paths['split']}", 1),
            ("shapenet_path: datasets/ShapeNetv2_data",
             f"shapenet_path: {paths['shapenet_path']}", 1),
            ("epochs: 240", f"epochs: {epochs}", 1),
            ("path: out/iscnet", f"path: {os.path.join(tmp, 'runs')}", 1)]


class StepProbe:
    """Wraps the loop's train and eval steps: each step's phase, loss
    terms and kernel launches (counts read before and after it), and with
    `keep_first` the first train step's gradients and the running
    statistics after it."""

    def __init__(self, keep_first: bool = False):
        from rfdnet_tpu_torch.train import loop

        self.loop, self.steps = loop, []
        self.saved = (loop.train_step, loop.eval_step)
        self.keep_first, self.first = keep_first, None

    def wrap(self, fn, phase):
        def step(*args, **kw):
            before = read_launches()
            losses = fn(*args, **kw)
            after = read_launches()
            if self.keep_first and phase == "train" and self.first is None:
                model, optimizer = args[:2]
                self.first = dict(
                    grads=[torch.zeros_like(p) if p.grad is None
                           else p.grad.detach().clone()
                           for p in optimizer.params],
                    stats={n: b.detach().clone() for n, b
                           in model.named_buffers() if "running" in n})
            self.steps.append(dict(phase=phase, losses={
                k: float(v) for k, v in losses.items()}, launches=launches_between(
                before, after)))
            return losses
        return step

    def __enter__(self):
        self.loop.train_step = self.wrap(self.saved[0], "train")
        self.loop.eval_step = self.wrap(self.saved[1], "val")
        return self

    def __exit__(self, *exc):
        self.loop.train_step, self.loop.eval_step = self.saved


def phase_loader(cfg3: str, tmp: str, workers: int = 8) -> dict:
    """The loader's two routes on the train phase's 80000-point scenes:
    one pass over the train items as one batch (all of them in flight on
    `workers` workers) for each, the process route's first pass (the
    pool's start included) and a second on the same pool; then for each
    route (`device.worker_type`) a stage-3 train run of four epochs at the
    train phase's batch 8, one train step an epoch, its loader wait a
    step. `fork_server` is the fork server's pid after each process pass
    and run: a change means that a pool started a new server."""
    from multiprocessing import forkserver

    from rfdnet_tpu_torch import cli, config
    from rfdnet_tpu_torch.data import scannet

    servers = []

    def server():
        servers.append(forkserver._forkserver._forkserver_pid)

    cfg = config.load_config(cfg3, mode="train")
    ds = cli._build_loaders(cfg, ["train"])["train"].dataset
    n = len(ds)
    passes, batches = {}, {}
    for route in ("thread", "process"):
        loader = scannet.DataLoader(ds, n, num_workers=workers,
                                    worker_type=route)
        times = []
        for _ in range(2 if route == "process" else 1):
            t0 = time.perf_counter()
            got = list(loader)
            times.append(time.perf_counter() - t0)
            if route == "process":
                server()
        batches[route] = got
        loader.close()
        passes[route] = dict(items=n, items_per_s=[n / s for s in times],
                             pass_s=times)
    same = all(sorted(a) == sorted(b) and all(
        a[k] == b[k] if isinstance(a[k], list) else
        bool((a[k] == b[k]).all()) for k in a)
        for a, b in zip(batches["thread"], batches["process"]))
    runs, launches = {}, {}
    for route in ("thread", "process"):
        path = config_copy(cfg3, os.path.join(tmp, f"loader_{route}.yaml"), [
            ("epochs: 3", "epochs: 4", 1),
            (f"num_workers: {workers}\n",
             f"num_workers: {workers}\n  worker_type: {route}\n", 1)])
        trainer, steps, wall = train_cli(path)
        if route == "process":
            server()
        waits = [s["loader_ms"] for s in trainer.step_times
                 if s["phase"] == "train"]
        launches[route] = [s["launches"] for s in steps
                           if s["phase"] == "train"][0]
        runs[route] = dict(steps=len(waits), loader_ms=waits,
                           loader_ms_spread=spread(waits), cli_s=wall,
                           val_loader_ms=[s["loader_ms"] for s in
                                          trainer.step_times
                                          if s["phase"] == "val"],
                           device_ms=spread([s["device_ms"] for s in
                                             trainer.step_times
                                             if s["phase"] == "train"]))
    emit(phase="loader", workers=workers, cores=os.cpu_count(),
         passes=passes, same_batches=same, train_runs=runs,
         fork_server=servers)
    check(same, "loader: the process route's items differ from the "
          "threads'")
    check(all(r["steps"] >= 4 for r in runs.values()),
          f"loader: train runs of {[r['steps'] for r in runs.values()]} "
          "steps")
    check(all(v == {"fps": 5, "cbn_decode": 0, "adam": 1}
              for v in launches.values()),
          f"loader: launches of a batch-8 train step {launches}")
    return dict(passes=passes, train_runs=runs, launches=launches)


def train_cli(cfg_path: str):
    """`cli.main --mode train` on `cfg_path` with its steps probed; returns
    (trainer, the probe's steps, host seconds)."""
    from rfdnet_tpu_torch import cli

    with StepProbe() as probe:
        t0 = time.perf_counter()
        trainer = cli.main(["--config", cfg_path, "--mode", "train"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return trainer, probe.steps, wall


def train_reference(dev, num_points: int = 4096) -> dict:
    """One stage-3 train step at `num_points`, batch 2, on the card and on
    the CPU, from the same seeded weights, batch (scene points on a 1/128
    grid, so that their distances are exact on both) and posterior noise.
    Exact: the FPS indices and the selected proposals. Loss terms: atol
    1e-4, rtol 1e-3 (the devices sum in other orders through ~20
    train-mode batch norms). Parameters: Adam's first step moves each by
    at most lr x its LR scale, so the two differ by at most twice that;
    the share that differ by more than 1e-3 of it is reported. Running
    statistics: atol 0.1, rtol 5e-2 (PointSeg's batch norms of a
    max-pooled feature over few samples keep few digits of their
    variance; the first run read 0.94 of atol 5e-2, rtol 2e-2, the JAX
    step test's tolerance), the worst named."""
    import copy

    import numpy as np

    from rfdnet_tpu_torch import config, weights
    from rfdnet_tpu_torch.data.synthetic import synthetic_scene_batch
    from rfdnet_tpu_torch.models.common import set_bn_momentum
    from rfdnet_tpu_torch.train.loop import Trainer
    from rfdnet_tpu_torch.train.trainer import train_step

    cfg = config.load_config(TRAIN_YAML, mode="train")
    cfg["data"]["num_point"] = num_points
    b = synthetic_scene_batch(np.random.RandomState(SEED), batch_size=2,
                              num_points=num_points, num_objects=8,
                              mean_size_arr=config.MEAN_SIZE_ARR)
    pc = b["point_clouds"]
    pc[..., :3] = np.round(pc[..., :3] * 128) / 128
    floor = np.percentile(pc[..., 2], 0.99, axis=1)[:, None]
    pc[..., 3] = np.round((pc[..., 2] - floor) * 128) / 128
    g = torch.Generator().manual_seed(SEED)
    eps = torch.randn(2 * cfg["data"]["completion_limit_in_train"],
                      cfg["data"]["z_dim"], generator=g)
    card = weights.init_seeded(config.build_model(cfg, device=dev,
                                                  mode="train"), SEED)
    cpu = copy.deepcopy(card).to("cpu")
    bnm = config.bn_momentum(cfg, 0)
    lr = cfg["optimizer"]["lr"]
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        batch = {k: torch.from_numpy(np.array(v)).to(d) for k, v in b.items()}
        probe = copy.deepcopy(model).train()
        set_bn_momentum(probe, bnm)
        with torch.no_grad():
            ep, _, _, pids = probe(batch, eps=eps.to(d))
        trainer = Trainer(cfg, model)
        set_bn_momentum(model, bnm)
        losses = train_step(model, trainer.optimizer, batch, lr,
                            trainer.completion_weight, eps=eps.to(d))
        out[name] = dict(ep=ep, pids=pids, losses=losses,
                         state=model.state_dict())
    c, p = out["card"], out["cpu"]
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds"):
        check(torch.equal(c["ep"][k].cpu(), p["ep"][k]),
              f"train reference: {k} differ between the card and the CPU")
    check(torch.equal(c["pids"].cpu(), p["pids"]),
          "train reference: selected proposals differ")
    loss_err = {k: float((c["losses"][k].cpu() - v).abs())
                for k, v in p["losses"].items()}
    for k, v in p["losses"].items():
        check(loss_err[k] <= 1e-4 + 1e-3 * float(v.abs()),
              f"train reference: {k} {float(c['losses'][k])} against "
              f"{float(v)}")
    param_err, beyond, total, stat_err, worst = 0.0, 0, 0, 0.0, None
    names = dict(card.named_parameters())
    for k, v in p["state"].items():
        got = c["state"][k].cpu()
        if k in names:
            d = (got - v).abs()
            param_err = max(param_err, float(d.max()) / lr)
            beyond += int((d > 1e-3 * lr).sum())
            total += d.numel()
        elif "running" in k:
            err = float(((got - v).abs() / (0.1 + 5e-2 * v.abs())).max())
            if err > stat_err:
                stat_err, worst = err, k
    check(param_err <= 2 * (1 + 1e-3),
          f"train reference: a parameter moved {param_err} x lr apart")
    check(stat_err <= 1.0, f"train reference: running statistics "
          f"{stat_err} x their tolerance apart")
    return dict(points=num_points, loss_err=loss_err,
                param_err_over_lr=param_err,
                params_beyond_1e3_lr=beyond / total,
                stats_err_over_tol=stat_err, stats_worst=worst,
                selected=int(c["pids"].shape[1]))


ADAM_STEPS = 3
# the spec with weight decay and an LR scale that the `adam` phase gives
# the completion network (the configurations ship neither)
ADAM_OVERRIDE = {"lr": 2.5e-5, "weight_decay": 1e-2, "betas": [0.8, 0.99]}


def library_adam(opt, grads, lr: float, reps: int) -> tuple:
    """The library's update on the same leaves: `torch._fused_adam_`,
    what `torch.optim.Adam(fused=True)` runs, one call a spec as it makes
    one a parameter group (coupled L2, eps after the square root), on
    copies of `opt`'s parameters and moments with `grads`. Returns its
    CUDA-event ms a step (the calls alone, the step counters set
    beforehand) and the largest difference of its parameters after one
    step from the plain version's (which the kernel equals bit for bit):
    the roundings differ, sqrt(nu) / sqrt(c2) there for sqrt(nu / c2)."""
    from rfdnet_tpu_torch.train import trainer as tt

    step = opt.count + 1
    calls = []
    for k, spec in enumerate(opt.groups):
        leaves = [i for i, j in enumerate(opt.spec_index) if j == k]
        p, m, v = ([t[i].detach().clone() for i in leaves]
                   for t in (opt.params, opt.mu, opt.nu))
        steps = [torch.full((), float(step), device=p[0].device)
                 for _ in leaves]
        calls.append((spec, leaves, p, [grads[i] for i in leaves], m, v,
                      steps))
    plain = [t.detach().clone() for t in opt.params]
    tt.adam_update_plain(plain, grads, [t.clone() for t in opt.mu],
                         [t.clone() for t in opt.nu], opt.spec_index,
                         opt.groups, step, lr)

    def update():
        for spec, _, p, g, m, v, steps in calls:
            torch._fused_adam_(
                p, g, m, v, [], steps, lr=lr * spec.lr_scale,
                beta1=spec.betas[0], beta2=spec.betas[1],
                weight_decay=spec.weight_decay, eps=spec.eps, amsgrad=False,
                maximize=False, grad_scale=None, found_inf=None)

    update()
    torch.cuda.synchronize()
    err = max(float((p[n] - plain[i]).abs().max())
              for _, leaves, p, *_ in calls for n, i in enumerate(leaves))
    return cuda_ms(update, reps), err


def phase_adam(dev, reps: int = 20) -> dict:
    """The Adam kernel against its plain version (see the module
    docstring): the stage-3 model's leaves, every submodule trainable,
    and the completion network's by `ADAM_OVERRIDE`; `ADAM_STEPS` steps
    through `Adam.step` (the kernel) and through `adam_update_plain` on
    card tensors from the same seeded gradients (a third of each leaf's
    values exactly 0), p, mu and nu equal bit for bit after each, one
    launch a step. Times: the kernel alone (CUDA events over `reps`
    launches on one table), a whole `Adam.step` (table, copy, launch) on
    the card's clock and on the host's, the plain version's and the
    library's (`library_adam`); the bound by bytes (p, g, mu, nu read, p, mu, nu written once)."""
    import copy

    from rfdnet_tpu_torch import config
    from rfdnet_tpu_torch.train import trainer as tt

    cfg = config.load_config(TRAIN_YAML, mode="train")
    model = config.build_model(cfg, device=dev, mode="train")
    plain_model = copy.deepcopy(model)
    overrides = {**cfg["model"], "completion": {
        **cfg["model"]["completion"], "optimizer": ADAM_OVERRIDE}}
    spec_of = tt.make_optimizer_with_specs(cfg["optimizer"], overrides)
    opt = tt.Adam(tt.freeze(model, ()), spec_of)
    params = [p for _, p in tt.freeze(plain_model, ())]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    lr = float(cfg["optimizer"]["lr"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    steps = []
    for step in range(1, ADAM_STEPS + 1):
        grads = []
        for p in opt.params:
            g = torch.randn(p.shape, generator=gen, device=dev)
            g.view(-1)[::3] = 0.0
            grads.append(g)
        for p, g in zip(opt.params, grads):
            p.grad = g.clone()
        reset_launches()
        opt.step(lr)
        torch.cuda.synchronize()
        launches = read_launches()
        tt.adam_update_plain(params, grads, mu, nu, opt.spec_index,
                             opt.groups, step, lr)
        torch.cuda.synchronize()
        unequal = {what: sum(not torch.equal(a, b) for a, b in zip(x, y))
                   for what, x, y in (("p", opt.params, params),
                                      ("mu", opt.mu, mu), ("nu", opt.nu, nu))}
        err = max(float((a.detach() - b.detach()).abs().max())
                  for a, b in zip(opt.params + opt.mu + opt.nu,
                                  params + mu + nu))
        steps.append(dict(step=step, launches=launches,
                          unequal_leaves=unequal, max_abs_err=err))
    elements = sum(p.numel() for p in opt.params)
    lib = tt._adam_lib()
    grads = [p.grad for p in opt.params]
    host, n_chunks = tt.adam_table(
        opt.params, grads, opt.mu, opt.nu, opt.spec_index, opt.groups,
        ADAM_STEPS + 1, lr, lib.rfd_adam_chunk(), tt._pinned)
    table = host.to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        check(lib.rfd_adam_launch(table.data_ptr(), len(opt.params),
                                  len(opt.groups), n_chunks, stream) == 0,
              "adam: the launch failed")

    ms = cuda_ms(launch, reps)
    step_ms = cuda_ms(lambda: opt.step(lr), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        opt.step(lr)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: tt.adam_update_plain(
        params, grads, mu, nu, opt.spec_index, opt.groups, 1, lr), 3)
    library_ms, library_err = library_adam(opt, grads, lr, reps)
    bound, by = bound_ms(28.0 * elements, 0.0, 1.0)
    row = dict(leaves=len(opt.params), elements=elements,
               specs=[dataclasses.asdict(g) for g in opt.groups],
               leaves_per_spec=[opt.spec_index.count(k)
                                for k in range(len(opt.groups))],
               chunks=n_chunks, steps=steps, ms=ms, step_ms=step_ms,
               step_host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=library_ms,
               library_max_abs_err=library_err,
               max_abs_err=max(s["max_abs_err"] for s in steps),
               launches=steps[0]["launches"].get("adam", 0))
    emit(phase="adam", **row)
    check(len(opt.groups) == 2 and min(row["leaves_per_spec"]) > 0,
          f"adam: specs {row['specs']} over {row['leaves_per_spec']} leaves")
    for st in steps:
        check(st["launches"] == {"fps": 0, "cbn_decode": 0, "adam": 1},
              f"adam: launches of step {st['step']}: {st['launches']}")
        check(not any(st["unequal_leaves"].values()),
              f"adam: step {st['step']} differs from the plain version: "
              f"{st['unequal_leaves']} leaves, {st['max_abs_err']}")
    return row


def phase_train(dev):
    """Training (see the module docstring). Returns the launches of one
    train step and one val step at full width."""
    import copy
    import math

    from rfdnet_tpu_torch import weights
    from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            paths = write_scannet_scenes(os.path.join(tmp, "data"),
                                         TRAIN_SCENES, seed=SEED,
                                         num_points=80000, num_objects=12)
            write_s = time.perf_counter() - t0
            full = train_pairs(paths, tmp, 3) + [
                ("finetune: true", "finetune: false", 1),
                ("weight:\n- out/iscnet/<stage2-run>/model_best\n",
                 "weight: []\n", 1)]
            cfg3 = config_copy(TRAIN_YAML, os.path.join(tmp, "stage3.yaml"),
                               full)
            torch.cuda.reset_peak_memory_stats()
            trainer, steps, wall = train_cli(cfg3)
            peak = torch.cuda.max_memory_allocated()
            run = trainer.save_path
            files = sorted(os.listdir(run))
            loaded = {}
            for name in ("model_best", "model_last"):
                lines = []
                weights.load_npz(copy.deepcopy(trainer.model), os.path.join(
                    run, name + ".npz"), log=lines.append)
                loaded[name] = lines
            # a fourth epoch, resumed from the run's model_last
            cfg4 = config_copy(cfg3, os.path.join(tmp, "stage3_resume.yaml"),
                               [("epochs: 3", "epochs: 4", 1),
                                ("resume: false", "resume: true", 1)])
            resumed, resumed_steps, resumed_wall = train_cli(cfg4)
            # stages 1 and 2 at 4096 points, batch 2, one step each
            small = write_scannet_scenes(os.path.join(tmp, "small"), 2,
                                         seed=SEED + 1, num_points=4096,
                                         num_objects=12)
            short = train_pairs(small, tmp, 1) + [
                ("num_point: 80000", "num_point: 4096", 1)]
            cfg1 = config_copy(DETECTION_YAML, os.path.join(tmp, "s1.yaml"),
                               short + [("batch_size: 8", "batch_size: 2", 2)])
            stage1, stage1_steps, _ = train_cli(cfg1)
            cfg2 = config_copy(COMPLETION_YAML, os.path.join(tmp, "s2.yaml"),
                               short + [
                                   ("batch_size: 8", "batch_size: 2", 2),
                                   ("- out/iscnet/<stage1-run>/model_best",
                                    "- " + os.path.join(stage1.save_path,
                                                        "model_best"), 1)])
            stage2, stage2_steps, _ = train_cli(cfg2)
            cbn = val_decode_row(trainer, cfg3)
            loader = phase_loader(cfg3, tmp)
        finally:
            os.chdir(cwd)
    reference = train_reference(dev)

    timed = [dict(s, launches=p["launches"])
             for s, p in zip(trainer.step_times, steps)]
    train_steps = [s for s in steps if s["phase"] == "train"]
    val_steps = [s for s in steps if s["phase"] == "val"]
    finite = all(math.isfinite(v) for s in steps + resumed_steps
                 + stage1_steps + stage2_steps for v in s["losses"].values())
    emit(phase="train", scenes=TRAIN_SCENES, points=80000,
         batch=trainer.cfg["train"]["batch_size"], write_scenes_s=write_s,
         cli_s=wall, peak_memory_gib=peak / 2 ** 30, steps=timed,
         losses=[dict(phase=s["phase"], **s["losses"]) for s in steps],
         files=files, loaded=loaded,
         resumed_epochs=sorted({s["epoch"] for s in resumed.step_times}),
         resumed_cli_s=resumed_wall,
         stage1=dict(steps=stage1_steps, sampling=stage1.model.detection
                     .sampling, phase=stage1.model.phase),
         stage2=dict(steps=stage2_steps, frozen=list(stage2.frozen)),
         reference=reference, cbn_decode_val=cbn)
    check(len(train_steps) == 3 and len(val_steps) == 3,
          f"train: {len(train_steps)} train and {len(val_steps)} val steps")
    check(finite, "train: a loss is not finite")
    check(all(s["launches"] == {"fps": 5, "cbn_decode": 0, "adam": 1}
              for s in train_steps),
          "train: launches of the train steps "
          f"{[s['launches'] for s in train_steps]}")
    check(all(s["launches"] == {"fps": 5, "cbn_decode": 1}
              for s in val_steps),
          "train: launches of the val steps "
          f"{[s['launches'] for s in val_steps]}")
    for name in ("model_best", "model_last"):
        check(f"{name}.npz" in files and loaded[name][0] == "set() subnet "
              "missed.", f"train: {name} missing or not loaded: {loaded}")
    check(sorted({s["epoch"] for s in resumed.step_times}) == [3],
          "train: the resumed run did not start from epoch 3")
    check(stage1.model.detection.sampling == "vote_fps"
          and stage2.frozen == ("backbone", "voting", "detection")
          and len(stage1_steps) == 2 and len(stage2_steps) == 2,
          "train: stages 1 and 2")
    return (train_steps[0]["launches"], val_steps[0]["launches"], cbn,
            loader["launches"])


def val_decode_row(trainer, cfg_path: str) -> dict:
    """The CBN kernel against its plain version on the operands of a
    full-width val step's one decode (80 proposals x 2048 points, the
    posterior-mean z), captured from `eval_step` on a val batch."""
    import rfdnet_tpu_torch.models.occnet as occnet
    from rfdnet_tpu_torch import cli, config
    from rfdnet_tpu_torch.train.loop import to_device
    from rfdnet_tpu_torch.train.trainer import eval_step

    cfg = config.load_config(cfg_path, mode="train")
    batch = next(iter(cli._build_loaders(cfg, ["val"])["val"]))
    captured, launch = [], occnet.fused_cbn_decode

    def capture(*ops, **kw):
        captured.append(ops)
        return launch(*ops, **kw)

    occnet.fused_cbn_decode = capture
    try:
        eval_step(trainer.model, to_device(batch, trainer.device),
                  trainer.completion_weight)
    finally:
        occnet.fused_cbn_decode = launch
    check(len(captured) == 1, f"train: {len(captured)} decodes in a val step")
    with torch.no_grad():
        row = cbn_row(captured[0])
        bf16_row("train_val_t2048", captured[0])
    row.pop("out")
    check(row["max_abs_err"] <= row["tol"],
          f"train: cbn_decode at the val decode: kernel vs plain max err "
          f"{row['max_abs_err']} > {row['tol']}")
    return row


# ---------------------------------------------------------------- parallel
@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on this process's card, as
    `rfdnet_tpu_torch.parallel.mesh.init_group` joins a rank (at a free
    port of localhost), destroyed on exit so that later phases run as
    before."""
    import torch.distributed as dist

    from rfdnet_tpu_torch.parallel.mesh import free_port, init_group

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    group = init_group("nccl")
    try:
        yield group
    finally:
        dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)


def served_numpy(out) -> dict:
    """`grids`, `parsed` and `gen` of a served output on the host."""
    return {"grids": out["grids"].cpu().numpy(),
            **{part: {k: v.cpu().numpy() for k, v in out[part].items()
                      if v.dim()} for part in ("parsed", "gen")}}


def ap_table(cfg, out, gt: dict, scenes: int) -> dict:
    """The Tester's AP protocol (its `eval_config`) on served outputs:
    each scene's confident proposals and GT boxes, one scene a step."""
    from rfdnet_tpu_torch import config
    from rfdnet_tpu_torch.eval import ap_helper

    ec = config.eval_config(cfg)
    calc = ap_helper.APCalculator(0.25, config.CLASS2TYPE)
    for i in range(scenes):
        calc.step(ap_helper.assembly_pred_map_cls(
            {k: v[i:i + 1] for k, v in out["parsed"].items()},
            conf_thresh=ec["conf_thresh"],
            per_class_proposal=ec["per_class_proposal"],
            proposal_ids=out["gen"]["proposal_ids"][i:i + 1]),
            ap_helper.assembly_gt_map_cls(ap_helper.parse_groundtruths(
                {k: v[i:i + 1] for k, v in gt.items()})))
    return calc.compute_metrics(parallel=False)


SERVE_SCENES = 8
GT_KEYS = ("center_label", "heading_class_label", "heading_residual_label",
           "size_class_label", "size_residual_label", "box_label_mask",
           "sem_cls_label")


def serve_kw(cfg) -> dict:
    """The keywords of `make_sharded_generate` for `cfg` (the test path's)."""
    from rfdnet_tpu_torch import config

    gen_cfg, ec = cfg["generation"], config.eval_config(cfg)
    return dict(nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
                dump_threshold=gen_cfg["dump_threshold"],
                remove_empty_box=ec["remove_empty_box"],
                decode_grid_res=gen_cfg["resolution_0"])


def serve_scenes(cfg, dev):
    """The served batch: SERVE_SCENES synthetic scenes of the config's
    size, 12 objects each, from this script's seed -> (the numpy batch
    with its GT fields, the point clouds on `dev`)."""
    import numpy as np

    from rfdnet_tpu_torch import config
    from rfdnet_tpu_torch.data.synthetic import synthetic_scene_batch

    full = synthetic_scene_batch(
        np.random.RandomState(SEED), batch_size=SERVE_SCENES,
        num_points=cfg["data"]["num_point"], num_objects=12,
        mean_size_arr=config.MEAN_SIZE_ARR)
    return full, torch.from_numpy(full["point_clouds"]).to(dev)


def phase_serve(model, cfg, dev, reps: int = 3):
    """Batched serving (`parallel.serve.make_sharded_generate`) of the test
    config on eight synthetic 80000-point scenes with 12 objects each: one
    batch of 8 with no group (`reps` timed calls after a warm-up), the
    same batch in a one-rank NCCL group, and 8 batch-1 calls. The AP
    tables of the three equal; the grids agree within the CBN kernel's
    tolerance where the same proposal fills the same slot. Returns the
    launches of each."""
    import numpy as np

    from rfdnet_tpu_torch.parallel.serve import make_sharded_generate

    gen_cfg = cfg["generation"]
    kw = serve_kw(cfg)
    full, pc = serve_scenes(cfg, dev)
    gt = {k: full[k] for k in GT_KEYS}

    def timed(serve, batches):
        """A warm-up on batches[0], then one synchronised call a batch:
        host ms each, the first's launches, every output on the host."""
        serve({"point_clouds": batches[0]})
        torch.cuda.synchronize()
        ms, outs = [], []
        for i, b in enumerate(batches):
            if i == 0:
                reset_launches()
            t0 = time.perf_counter()
            out = serve({"point_clouds": b})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches = read_launches()
            outs.append(served_numpy(out))
            del out
        return ms, launches, outs

    serve = make_sharded_generate(model, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms8, launches8, outs8 = timed(serve, [pc] * reps)
        peak = torch.cuda.max_memory_allocated()
        ms1, launches1, singles = timed(
            serve, [pc[i:i + 1] for i in range(SERVE_SCENES)])
        with one_rank_group() as group:
            msg, launches_g, outs_g = timed(
                make_sharded_generate(model, group, **kw), [pc] * 2)
        cbn = serve_decode_row(model, serve, pc)
    b8, g8 = outs8[0], outs_g[0]
    b1 = {"grids": np.concatenate([s["grids"] for s in singles]),
          **{part: {k: np.concatenate([s[part][k] for s in singles])
                    for k in singles[0][part]} for part in ("parsed", "gen")}}
    tables = {name: ap_table(cfg, out, gt, SERVE_SCENES)
              for name, out in (("b8", b8), ("b1", b1), ("group", g8))}

    def grid_agreement(a, b):
        same = (a["gen"]["valid"].reshape(-1) & b["gen"]["valid"].reshape(-1)
                & (a["gen"]["proposal_ids"].reshape(-1, 3)
                   == b["gen"]["proposal_ids"].reshape(-1, 3)).all(1))
        err = float(np.abs(a["grids"][same] - b["grids"][same]).max()
                    ) if same.any() else 0.0
        scale = max(float(np.abs(b["grids"]).max()), 1.0)
        return dict(same_slots=int(same.sum()), valid=int(
            b["gen"]["valid"].sum()), max_abs_err=err, tol=1e-4 * scale)

    t8, t1 = sum(ms8) / len(ms8), sum(ms1) / len(ms1)
    res = gen_cfg["resolution_0"]
    row = dict(
        scenes=SERVE_SCENES, points=int(pc.shape[1]),
        grids=list(b8["grids"].shape),
        finite=bool(np.isfinite(b8["grids"]).all()),
        batch8_ms=ms8, batch8_ms_mean=t8, scenes_per_s=SERVE_SCENES * 1e3 / t8,
        batch1_ms=ms1, batch1_ms_mean=t1,
        scenes_per_s_batch1=1e3 / t1,
        overhead_per_scene=(t8 / SERVE_SCENES) / t1 - 1.0,
        group_ms=msg, peak_memory_gib=peak / 2 ** 30,
        launches=dict(b8=launches8, b1=launches1, group=launches_g),
        b8_vs_b1=grid_agreement(b8, b1), group_vs_b8=grid_agreement(g8, b8),
        ap_equal=tables["b8"] == tables["b1"] == tables["group"],
        cbn_decode=cbn,
        map_025=tables["b8"].get("mAP"),
        pred_mask=int(b8["parsed"]["pred_mask"].sum()),
        valid=int(b8["gen"]["valid"].sum()))
    emit(phase="serve", **row)
    check(row["grids"] == [SERVE_SCENES * model.generate_limit] + [res] * 3
          and row["finite"], f"serve: grids {row['grids']}")
    for name, counts in row["launches"].items():
        check(counts == {"fps": 5, "cbn_decode": 1},
              f"serve: launches of a {name} call {counts}")
    check(row["ap_equal"], "serve: the AP tables of batch 8, batch 1 and the "
          f"group differ: {tables}")
    for name in ("b8_vs_b1", "group_vs_b8"):
        a = row[name]
        check(a["max_abs_err"] <= a["tol"] and a["same_slots"] >= 0.9 * a[
            "valid"], f"serve: grids {name}: {a}")
    check(cbn["max_abs_err"] <= cbn["tol"], f"serve: cbn_decode at the "
          f"batch's decode: kernel vs plain {cbn}")
    return row["launches"], cbn, t8


def serve_decode_row(model, serve, pc) -> dict:
    """The CBN kernel against its plain version (`cbn_row`, the plain
    version and the cuBLAS chain 64 proposals at a time) on the operands
    of a served batch's grid decode, captured from a call."""
    import rfdnet_tpu_torch.models.occnet as occnet

    captured, launch = [], occnet.fused_cbn_decode

    def capture(*ops, **kw):
        captured.append(ops)
        return launch(*ops, **kw)

    occnet.fused_cbn_decode = capture
    try:
        serve({"point_clouds": pc})
    finally:
        occnet.fused_cbn_decode = launch
    check(len(captured) == 1, f"serve: {len(captured)} decodes in a call")
    row = cbn_row(captured[0], reps=2, chunk=64)
    row.pop("out")
    bf16_row("serve_b8", captured[0], reps=2, chunk=64)
    return row


def phase_decoder_bf16(model, cfg, data, serve_ms: float, scenes: int = 10,
                       reps: int = 3, num_points: int = 4096):
    """The bf16 route of the CBN decoder on the card, at full width:
    - the demo scene to the grids with `data.decoder_bf16: true` (the
      model's seeded weights), in turns with f32 (f32, bf16, bf16, f32),
      `scenes` timed scenes each: latency, launches (the grid decode on the
      bf16 kernel), the grids' distance and the share of grid points whose
      sign differs, and the meshes of each valid slot against the f32
      ones: each vertex within a cell of the other mesh's (Hausdorff
      distance of the vertex sets; the mesh check: a few grid points of
      every slot change sign, so no slot's faces can be held equal);
    - a served batch of 8 (`parallel.serve`) at bf16: ms a batch, scenes
      a second, peak memory, launches, against the f32 batch's
      `serve_ms`;
    - one Tester scene (`dispatch_step`) with `generation.decoder_impl:
      pallas` and `decoder_bf16: false`: the grid decode on the bf16
      kernel, the completion loss and the 16^3 voxels on the f32 one;
    - the layer-by-layer decoder at `decoder_bf16` (eval, `num_points`
      points a proposal) on the card against the CPU: within 2e-2 x scale
      with occupancy signs that agree except within 1e-2 x scale of 0
      (the bf16 tolerance of the CPU tests; the devices sum in other
      orders), and nearer the CPU's bf16 chain than its f32 one.
    Returns the launches of each path."""
    import copy

    import numpy as np

    import rfdnet_tpu_torch.models.occnet as occnet
    from rfdnet_tpu_torch import config, demo, weights
    from rfdnet_tpu_torch.eval.tester import Tester
    from rfdnet_tpu_torch.models.occnet import make_3d_grid
    from rfdnet_tpu_torch.parallel.serve import make_sharded_generate

    dev = next(model.parameters()).device
    pc = data["point_clouds"]
    bf16_cfg = copy.deepcopy(cfg)
    bf16_cfg["data"]["decoder_bf16"] = True
    bf16 = weights.init_seeded(config.build_model(bf16_cfg, device=dev), SEED)
    runs = {}
    for name, m, c in (("f32", model, cfg), ("bf16", bf16, bf16_cfg),
                       ("bf16_2", bf16, bf16_cfg), ("f32_2", model, cfg)):
        runs[name] = timed_scenes(lambda m=m, c=c: demo.generate_grids(
            c, m, pc), scenes)
    _, _, gen32, g32 = runs["f32"].pop("first")
    _, _, gen16, g16 = runs["bf16"].pop("first")
    for r in runs.values():
        r.pop("first", None)
    generator = demo.make_generator(cfg, model)
    valid = gen32["valid"].reshape(-1).cpu().numpy()
    same_slots = bool((gen16["valid"].reshape(-1).cpu().numpy() == valid)
                      .all())
    g32, g16 = g32.cpu().numpy(), g16.cpu().numpy()
    m32 = generator.meshes_from_grids(g32, valid=valid)
    m16 = generator.meshes_from_grids(g16, valid=valid)
    # the grids differ by up to ~7e-3 and a few points of every slot's
    # grid cross the iso level, so no mesh keeps f32's faces: each vertex
    # of either mesh lies within one cell of the other's (a value that
    # crosses the iso level moves the surface inside the cells around it)
    from scipy.spatial import cKDTree

    cell = (1 + generator.padding) / (g32.shape[1] - 1)
    hausdorff = 0.0
    for g in np.flatnonzero(valid):
        a, b = m16[g].vertices, m32[g].vertices
        if len(a) and len(b):
            hausdorff = max(hausdorff, float(cKDTree(b).query(a)[0].max()),
                            float(cKDTree(a).query(b)[0].max()))
        else:
            check(len(a) == len(b), f"decoder_bf16: slot {g} has a mesh "
                  "in one type only")
    hausdorff_cells = hausdorff / cell
    signs_differ = float(((g16[valid] > generator.iso)
                          != (g32[valid] > generator.iso)).mean())
    check(hausdorff_cells <= 1.0,
          f"decoder_bf16: vertices {hausdorff_cells} cells from f32's")
    demo_row = dict(
        scenes=scenes, runs={name: dict(
            wall_ms=r["wall_ms"], wall_ms_min=r["wall_ms_min"],
            wall_ms_max=r["wall_ms_max"], stage_ms=r["stage_ms"],
            launches=r["launches"]) for name, r in runs.items()},
        grid_max_diff=float(np.abs(g16 - g32).max()),
        finite=bool(np.isfinite(g16).all()), same_slots=same_slots,
        vertex_hausdorff_cells=hausdorff_cells,
        grid_signs_differ_share=signs_differ,
        triangles=dict(f32=sum(len(m.faces) for m in m32),
                       bf16=sum(len(m.faces) for m in m16)))

    # a served batch of 8 at bf16
    _, pc8 = serve_scenes(cfg, dev)
    serve = make_sharded_generate(bf16, **serve_kw(bf16_cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        serve({"point_clouds": pc8})
        torch.cuda.synchronize()
        ms8 = []
        for i in range(reps):
            if i == 0:
                reset_launches()
            t0 = time.perf_counter()
            out = serve({"point_clouds": pc8})
            torch.cuda.synchronize()
            ms8.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                serve_launches = read_launches()
                serve_finite = bool(torch.isfinite(out["grids"]).all())
            del out
    t8 = sum(ms8) / len(ms8)
    serve_row = dict(batch8_ms=ms8, batch8_ms_mean=t8,
                     scenes_per_s=SERVE_SCENES * 1e3 / t8,
                     f32_batch8_ms_mean=serve_ms,
                     peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                     launches=serve_launches, finite=serve_finite)
    del serve, pc8
    torch.cuda.empty_cache()

    # one Tester scene with decoder_impl: pallas, decoder_bf16 false
    test_cfg = config.load_config(TEST_YAML, mode="test")
    test_cfg["seed"] = SEED
    test_cfg["generation"]["decoder_impl"] = "pallas"
    full, _ = serve_scenes(cfg, "cpu")
    batch = {k: v[:1] for k, v in full.items()}
    decodes, launch = [], occnet.fused_cbn_decode

    def record(h0, *ops, mxu_dtype=torch.float32, **kw):
        decodes.append((int(h0.shape[1]), str(mxu_dtype).split(".")[-1]))
        return launch(h0, *ops, mxu_dtype=mxu_dtype, **kw)

    tester = Tester(test_cfg, model, log=lambda m: None)
    tester.dispatch_step(batch)  # warm-up
    torch.cuda.synchronize()
    occnet.fused_cbn_decode = record
    try:
        reset_launches()
        pending = tester.dispatch_step(batch)
        if pending["done"] is not None:
            pending["done"].synchronize()
        tester_launches = read_launches()
    finally:
        occnet.fused_cbn_decode = launch
    res = test_cfg["generation"]["resolution_0"]
    tester_row = dict(decodes=decodes, launches=tester_launches,
                      generate_ms=pending["spans"]["generate"].device_ms(),
                      grid_dtype=tester.grid_mxu_dtype is torch.bfloat16)

    # the layer chain at decoder_bf16, card against CPU
    onet = bf16.completion
    g = torch.Generator().manual_seed(SEED + 2)
    nb = 8
    c = torch.randn(nb, 512, generator=g) * 0.5
    p = 1.1 * make_3d_grid((-0.5,) * 3, (0.5,) * 3, (16,) * 3)[None].expand(
        nb, -1, -1)[:, :num_points]
    z = torch.zeros(nb, onet.z_dim)
    cpu = copy.deepcopy(onet).to("cpu")
    with torch.no_grad():
        card = onet.decode(p.to(dev), z.to(dev), c.to(dev)).cpu()
        want = cpu.decode(p, z, c)
        f32_chain = copy.deepcopy(model.completion).to("cpu").decode(p, z, c)
    scale = max(float(want.abs().max()), 1.0)
    chain_err = float((card - want).abs().max())
    near = want.abs() < 1e-2 * scale
    chain_row = dict(points=num_points, proposals=nb, max_abs_err=chain_err,
                     tol=2e-2 * scale,
                     err_vs_cpu_f32=float((card - f32_chain).abs().max()),
                     signs_agree=bool((((card >= 0) == (want >= 0)) | near)
                                      .all()))
    emit(phase="decoder_bf16", demo=demo_row, serve=serve_row,
         tester=tester_row, layer_chain=chain_row)
    check(demo_row["finite"] and same_slots,
          f"decoder_bf16: grids finite {demo_row['finite']}, "
          f"same slots {same_slots}")
    for name, r in demo_row["runs"].items():
        want_l = {"fps": 5, "cbn_decode": 1}
        if name.startswith("bf16"):
            want_l["cbn_decode_bf16"] = 1
        check(r["launches"] == want_l,
              f"decoder_bf16: launches of the {name} run {r['launches']}")
    check(serve_launches == {"fps": 5, "cbn_decode": 1, "cbn_decode_bf16": 1}
          and serve_finite, f"decoder_bf16: serve {serve_row}")
    check(tester_launches == {"fps": 5, "cbn_decode": 3,
                              "cbn_decode_bf16": 1}
          and sorted(decodes) == sorted([
              (int(batch["object_points"].shape[2]), "float32"),
              (16 ** 3, "float32"), (res ** 3, "bfloat16")]),
          f"decoder_bf16: the Tester's decodes {tester_row}")
    check(chain_err <= chain_row["tol"] and chain_row["signs_agree"]
          and chain_err < chain_row["err_vs_cpu_f32"],
          f"decoder_bf16: the layer chain card vs CPU {chain_row}")
    reset_launches()  # later phases read counts without the bf16 key
    return {"decoder_bf16_demo": runs["bf16"]["launches"],
            "decoder_bf16_serve_b8": serve_launches,
            "decoder_bf16_tester_pallas": tester_launches}


def ddp_run(cfg: dict, dev, group) -> dict:
    """`cli.run_train` of `cfg` on `dev` with the data group `group` (or
    none), seeded as the CLI seeds: each step's loss terms and launches,
    the first train step's gradients and the running statistics after
    it, the final parameters, the step times, the sync-BN all-reduces a
    train step."""
    import rfdnet_tpu_torch.models.common as common
    from rfdnet_tpu_torch import cli
    from rfdnet_tpu_torch.utils.logging import initiate_environment

    calls = [0]
    all_sum = common.all_sum

    def counted(x, g):
        calls[0] += g is not None
        return all_sum(x, g)

    common.all_sum = counted
    initiate_environment(cfg.get("seed", 10))
    try:
        with StepProbe(keep_first=True) as probe:
            trainer = cli.run_train(cfg, device=dev, group=group)
            torch.cuda.synchronize()
    finally:
        common.all_sum = all_sum
    train_steps = sum(s["phase"] == "train" for s in probe.steps)
    return dict(
        trainer=trainer, steps=probe.steps, **probe.first,
        params={n: p.detach().clone()
                for n, p in trainer.model.named_parameters()},
        step_times=trainer.step_times,
        sync_bn_per_train_step=calls[0] / max(train_steps, 1))


def ddp_errors(a: dict, b: dict, lr: float) -> dict:
    """How far run a is from run b. At the first train step (the same
    parameters in both): its loss terms (largest relative error, floor
    1e-6), gradients (relative L2 over all of them, and the largest of a
    tensor's) and the running statistics after it (largest error of a
    buffer over its largest value, floor 1). Over the run: the loss terms
    of every step, and the final parameters' largest error over the
    learning rate."""
    def loss_rel(sa, sb):
        return max(abs(sa["losses"][k] - v) / max(abs(v), 1e-6)
                   for k, v in sb["losses"].items())

    num = sum(float((ga - gb).double().square().sum())
              for ga, gb in zip(a["grads"], b["grads"]))
    den = sum(float(gb.double().square().sum()) for gb in b["grads"])
    names = a["trainer"].optimizer.names
    per = {n: float((ga - gb).double().norm() / gb.double().norm())
           for n, ga, gb in zip(names, a["grads"], b["grads"])
           if gb.abs().max() > 0}
    worst = max(per, key=per.get)
    return dict(
        first_loss_rel=loss_rel(a["steps"][0], b["steps"][0]),
        first_grad_rel_l2=(num / den) ** 0.5,
        first_grad_rel_l2_worst_tensor=per[worst],
        first_grad_worst_tensor=worst,
        first_stats_rel=max(
            float((a["stats"][n] - s).abs().max()
                  / max(float(s.abs().max()), 1.0))
            for n, s in b["stats"].items()),
        step_loss_rel=[loss_rel(sa, sb)
                       for sa, sb in zip(a["steps"], b["steps"])],
        param_abs_over_lr=max(float((a["params"][n] - p).abs().max())
                              for n, p in b["params"].items()) / lr)


DDP_EPOCHS = 3
# Fixed limits of the group run against the run alone, set above the
# floor of two runs alone on NVIDIA H100 80GB HBM3 at 700 W: first-step
# gradients 1.32e-6 and 1.33e-6 relative L2 (two calls), later steps'
# loss terms up to 0.080 relative (Adam steps on gradients that differ
# by the atomic adds' order).
DDP_GRAD_REL = 1e-5
DDP_STEP_LOSS_REL = 0.25


def phase_ddp(dev, reps: int = 3):
    """The data-parallel train step at world size 1 (see the module
    docstring). Returns the launches of the group run's first train and
    val steps."""
    from rfdnet_tpu_torch import config
    from rfdnet_tpu_torch.data.synthetic import write_scannet_scenes
    from rfdnet_tpu_torch.parallel.mesh import all_reduce_grads

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            paths = write_scannet_scenes(os.path.join(tmp, "data"),
                                         TRAIN_SCENES, seed=SEED,
                                         num_points=80000, num_objects=12)
            cfg_path = config_copy(
                TRAIN_YAML, os.path.join(tmp, "ddp.yaml"),
                train_pairs(paths, tmp, DDP_EPOCHS) + [
                    ("finetune: true", "finetune: false", 1),
                    ("weight:\n- out/iscnet/<stage2-run>/model_best\n",
                     "weight: []\n", 1)])
            cfg = config.load_config(cfg_path, mode="train")
            runs = {"alone": ddp_run(cfg, dev, None)}
            with one_rank_group() as group:
                runs["group"] = run = ddp_run(cfg, dev, group)
                params = run["trainer"].optimizer.params
                for p, g in zip(params, run["grads"]):
                    p.grad = g.clone()
                all_reduce_ms = cuda_ms(
                    lambda: all_reduce_grads(params, group), reps)
                backend = group.backend
                grad_mib = sum(p.numel() for p in params) * 4 / 2 ** 20
            runs["alone_again"] = ddp_run(cfg, dev, None)
        finally:
            os.chdir(cwd)
    lr = float(cfg["optimizer"]["lr"])
    # the group run against the run without one, and the run-to-run floor
    # of the same steps. Reported, not checked: the worst single tensor
    # (a gradient that nearly cancels, whose relative error the atomic
    # adds' order alone makes O(1)) and the final parameters (Adam
    # normalises each update to about lr, so any two runs of three steps
    # lie within about 6 lr of each other, faulty or not)
    errors = ddp_errors(runs["group"], runs["alone"], lr)
    floor = ddp_errors(runs["alone_again"], runs["alone"], lr)
    train_ms = {name: [s["device_ms"] for s in r["step_times"]
                       if s["phase"] == "train"] for name, r in runs.items()}
    val_ms = {name: [s["device_ms"] for s in r["step_times"]
                     if s["phase"] == "val"] for name, r in runs.items()}
    group_steps = runs["group"]["steps"]
    row = dict(
        world=1, backend=backend, batch=cfg["train"]["batch_size"],
        points=cfg["data"]["num_point"],
        steps=[s["phase"] for s in group_steps],
        losses=[dict(phase=s["phase"], **s["losses"]) for s in group_steps],
        train_device_ms=train_ms, val_device_ms=val_ms,
        all_reduce_ms=all_reduce_ms, grad_mib=grad_mib,
        sync_bn_all_reduces_per_train_step=runs["group"][
            "sync_bn_per_train_step"],
        launches=[s["launches"] for s in group_steps],
        group_vs_alone=errors, alone_vs_alone=floor,
        limits=dict(first=1e-5, grad_rel_l2=DDP_GRAD_REL,
                    step_loss_rel=DDP_STEP_LOSS_REL))
    emit(phase="ddp", **row)
    check(row["steps"] == ["train", "val"] * DDP_EPOCHS,
          f"ddp: steps {row['steps']}")
    for s in group_steps:
        want = ({"fps": 5, "cbn_decode": 0, "adam": 1}
                if s["phase"] == "train" else {"fps": 5, "cbn_decode": 1})
        check(s["launches"] == want, f"ddp: launches {s}")
    check(errors["first_loss_rel"] <= 1e-5
          and errors["first_stats_rel"] <= 1e-5,
          f"ddp: first step's losses or statistics {errors}")
    check(errors["first_grad_rel_l2"] <= DDP_GRAD_REL,
          f"ddp: first step's gradients {errors} > {DDP_GRAD_REL}")
    check(max(errors["step_loss_rel"]) <= DDP_STEP_LOSS_REL,
          f"ddp: later steps' losses {errors} > {DDP_STEP_LOSS_REL}")
    return group_steps[0]["launches"], group_steps[1]["launches"]


def phase_point_shard(model, data, reps: int = 3):
    """The point-sharded SA1 and the halo layout on the demo scene (80000
    points) in a one-rank NCCL group: `sa1_forward_sharded` against the
    model's SA1 (indices and centers equal, features within 1e-5 x
    scale); `ball_query_halo` on the x-sorted cloud against `ball_query`
    (indices equal) at SA1's 2048 centers; `fps_bucketed` with a budget
    that covers the cloud against exact FPS of the sorted cloud (indices
    equal), with and without the near-origin exclusion, its FPS kernel
    launches counted. Returns those launches."""
    from rfdnet_tpu_torch.ops import ball_query, furthest_point_sample
    from rfdnet_tpu_torch.ops.fps import fps_plain
    from rfdnet_tpu_torch.parallel import halo
    from rfdnet_tpu_torch.parallel import point_shard as ps

    pc = data["point_clouds"]
    xyz, feats = pc[..., :3].contiguous(), pc[..., 3:4].contiguous()
    sa = model.backbone.sa1
    N, npoint = xyz.shape[1], sa.npoint
    with torch.no_grad(), one_rank_group() as group:
        backend = group.backend
        new_xyz, new_feat, inds = sa(xyz, feats)
        got_xyz, got_feat, got_inds = ps.sa1_forward_sharded(sa, xyz, feats,
                                                             group)
        scale = max(float(new_feat.abs().max()), 1.0)
        sa1 = dict(
            inds_equal=bool(torch.equal(got_inds.long(), inds.long())),
            xyz_equal=bool(torch.equal(got_xyz, new_xyz)),
            feat_err=float((got_feat - new_feat).abs().max()),
            tol=1e-5 * scale,
            ms=cuda_ms(lambda: sa(xyz, feats), reps),
            sharded_ms=cuda_ms(lambda: ps.sa1_forward_sharded(
                sa, xyz, feats, group), 1, 0),
            fps_sharded_ms=cuda_ms(lambda: ps.fps_sharded(xyz, npoint,
                                                          group), 1, 0),
            fps_ms=cuda_ms(lambda: furthest_point_sample(xyz, npoint), reps),
            ball_query_sharded_ms=cuda_ms(lambda: ps.ball_query_sharded(
                xyz, new_xyz, sa.radius, sa.nsample, group), reps),
            ball_query_ms=cuda_ms(lambda: ball_query(
                xyz, new_xyz, sa.radius, sa.nsample), reps))
        xs, ids = halo.slab_sort(xyz)
        H = halo.required_halo(xs.cpu().numpy(), sa.radius, group.world)
        where = torch.argsort(ids, dim=1)  # original index -> sorted
        cidx = torch.gather(where, 1, inds.long())
        want = ball_query(xyz, new_xyz, sa.radius, sa.nsample)
        bq_h = halo.ball_query_halo(xs, ids, cidx, sa.radius, sa.nsample, H,
                                    group)
        bq = dict(H=H, equal=bool(torch.equal(bq_h, want.long())),
                  ms=cuda_ms(lambda: halo.ball_query_halo(
                      xs, ids, cidx, sa.radius, sa.nsample, H, group), reps))
        k_cover = -(-N // npoint)  # local_budget covers the slab
        bucketed = {}
        for skip in (True, False):
            reset_launches()
            got = halo.fps_bucketed(xs, npoint, group, k=k_cover,
                                    skip_near_origin=skip)
            launches = read_launches()
            exact = (furthest_point_sample(xs, npoint) if skip
                     else fps_plain(xs, npoint, skip_near_origin=False))
            bucketed["on" if skip else "off"] = dict(
                local_m=halo.local_budget(npoint, group.world, k_cover, N),
                equal=bool(torch.equal(got, exact.long())),
                launches=launches,
                ms=cuda_ms(lambda: halo.fps_bucketed(
                    xs, npoint, group, k=k_cover, skip_near_origin=skip),
                    reps))
    emit(phase="point_shard", world=1, backend=backend, points=N,
         npoint=npoint, radius=sa.radius, nsample=sa.nsample, sa1=sa1,
         ball_query_halo=bq, fps_bucketed=bucketed)
    check(sa1["inds_equal"] and sa1["xyz_equal"]
          and sa1["feat_err"] <= sa1["tol"], f"point_shard: sa1 {sa1}")
    check(bq["equal"], "point_shard: ball_query_halo differs from ball_query")
    for name, row in bucketed.items():
        check(row["equal"] and row["launches"] == {"fps": 2, "cbn_decode": 0},
              f"point_shard: fps_bucketed ({name}) {row}")
    return bucketed["off"]["launches"]


PREP_MESHES = os.path.join(ROOT, "demo", "outputs", "scene0549_00")
PREP_CATID = "04379243"  # ShapeNet's table synset: one category folder
PREP_OPEN = "open_seeded"  # the seeded non-watertight model
PREP_DEMO_MODELS = 7  # of the 13 demo meshes, the first by name
PREP_RES = 256  # the CLI's default --resolution
# the limits of a kernel against its plain version at full width: the
# share of pixels whose coverage differs and of voxels off by over 1e-6
# (a projection index that flips), and the largest depth error where both
# cover (0 expected: both do the same double operations in the same order)
PREP_FLIP_SHARE = 1e-4
PREP_DEPTH_ERR = 1e-6
# the card's route against the CPU's on one model: watertight meshes
# within half a voxel, occupancy labels equal on this share
PREP_VOXEL_TOL = 0.5
PREP_LABEL_AGREE = 0.999
# the ScanNet prep's raw scene: points inside each of its 3 CAD boxes and
# on its floor, ~160k in all, as a ScanNet scan's `_vh_clean_2.ply`
PREP_SCAN_OBJECT_POINTS = 20_000
PREP_SCAN_FLOOR_POINTS = 100_000
FP64_FLOPS = 34e12  # FP64 outside the tensor cores, H100 SXM data sheet


def grid_patch(ku: int, kv: int, fn):
    """A (ku x kv)-quad grid of fn(s, t) over [0, 1]^2: (verts, faces)."""
    import numpy as np

    s, t = np.meshgrid(np.linspace(0, 1, ku + 1), np.linspace(0, 1, kv + 1),
                       indexing="ij")
    verts = fn(s.ravel(), t.ravel())
    idx = np.arange((ku + 1) * (kv + 1)).reshape(ku + 1, kv + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return verts, faces


def open_mesh(seed: int = SEED, k: int = 30):
    """A non-watertight mesh of ~50k faces from `seed`: four boxes without
    their tops (five k x k faces each) and a sphere with a cap cut away
    (70 x 100 quads), at random places and sizes. Returns (verts, faces)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    parts = []
    for _ in range(4):
        lo = rng.uniform(-0.6, 0.1, 3)
        size = rng.uniform(0.25, 0.5, 3)
        for axis, side in ((2, 0), (0, 0), (0, 1), (1, 0), (1, 1)):
            u, v = [a for a in range(3) if a != axis]

            def face(s, t, axis=axis, side=side, u=u, v=v):
                p = np.empty((len(s), 3))
                p[:, axis] = lo[axis] + side * size[axis]
                p[:, u] = lo[u] + s * size[u]
                p[:, v] = lo[v] + t * size[v]
                return p
            parts.append(grid_patch(k, k, face))
    center, radius = rng.uniform(-0.2, 0.2, 3), 0.3

    def sphere(s, t):
        theta = 0.6 + s * (np.pi - 0.6)  # the cap above 0.6 rad is cut
        phi = 2 * np.pi * t
        return center + radius * np.stack([np.sin(theta) * np.cos(phi),
                                           np.sin(theta) * np.sin(phi),
                                           np.cos(theta)], 1)
    parts.append(grid_patch(70, 100, sphere))
    verts, faces, base = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + base)
        base += len(v)
    return np.concatenate(verts), np.concatenate(faces).astype(np.int32)


def prep_inputs(in_root: str) -> list:
    """The prep phase's models under in_root/<catid>/<model>/model.off: the
    checked-in demo meshes and the seeded open mesh. Returns their names."""
    import glob

    from rfdnet_tpu_torch.meshing.mesh import TriMesh, write_off

    names = []
    for path in sorted(glob.glob(os.path.join(
            PREP_MESHES, "proposal_*_mesh.ply")))[:PREP_DEMO_MODELS]:
        name = os.path.basename(path)[:-len("_mesh.ply")]
        os.makedirs(os.path.join(in_root, PREP_CATID, name))
        TriMesh.load(path).export(
            os.path.join(in_root, PREP_CATID, name, "model.off"))
        names.append(name)
    os.makedirs(os.path.join(in_root, PREP_CATID, PREP_OPEN))
    write_off(os.path.join(in_root, PREP_CATID, PREP_OPEN, "model.off"),
              *open_mesh())
    return names + [PREP_OPEN]


def prep_kernel_rows(name: str, mesh, dev, reps: int = 3) -> dict:
    """Both kernels against their plain versions (on the card) on one
    model at the CLI's full width: its normalised mesh rendered from
    every view, then those depths fused at the default resolution."""
    import numpy as np

    from rfdnet_tpu_torch.ops import fusion
    from rfdnet_tpu_torch.prep import shapenet as sn

    verts = np.asarray(mesh.vertices)
    center = (verts.max(0) + verts.min(0)) / 2.0
    scale = (verts.max(0) - verts.min(0)).max() / (1 - sn.PADDING)
    poses = np.stack([sn.look_at_pose(e)
                      for e in sn.fibonacci_views(sn.N_VIEWS) * 2.0])
    v = torch.from_numpy((verts - center) / scale).to(dev)
    t = torch.from_numpy(np.ascontiguousarray(mesh.faces, np.int32)).to(dev)
    p = torch.from_numpy(poses).to(dev)
    cam = (sn.FOCAL, sn.IMAGE / 2.0, sn.IMAGE / 2.0)
    view = cam + (sn.IMAGE, sn.IMAGE)
    depth = fusion.render_depth(v, t, p, *view)
    work = {}
    plain, plain_ms = timed_once(
        lambda: fusion.render_depth_plain(v, t, p, *view, work=work))
    both = (depth > 0) & (plain > 0)
    render = dict(
        model=name, views=sn.N_VIEWS, width=sn.IMAGE, height=sn.IMAGE,
        triangles=len(t), vertices=len(v), work=work,
        covered_share=float((depth > 0).float().mean()),
        coverage_differs=int(((depth > 0) != (plain > 0)).sum()),
        max_abs_err=float((depth - plain).abs()[both].max()),
        ms=cuda_ms(lambda: fusion.render_depth(v, t, p, *view), reps),
        plain_ms=plain_ms, library_ms=None)
    # the FP64 operations this input needs: each vertex to camera space a
    # view (18), each drawn triangle's projection, determinant and inverse
    # depths (26), each pixel of its box's weights (20), each covered
    # pixel's depth (6); the bytes: mesh and poses in, the depths out
    render["bound_ms"], render["bound_by"] = bound_ms(
        v.numel() * 8 + t.numel() * 4 + p.numel() * 8 + depth.numel() * 4,
        18 * len(v) * sn.N_VIEWS + 26 * work["drawn"]
        + 20 * work["box_pixels"] + 6 * work["covered"], FP64_FLOPS)
    pixels = depth.numel()
    res = PREP_RES
    fuse_args = (*cam, res, (-0.5, -0.5, -0.5, 0.5, 0.5, 0.5), 10.0 / res)
    tsdf = fusion.tsdf_fuse(depth, p, *fuse_args)
    work = {}
    tplain, tplain_ms = timed_once(
        lambda: fusion.tsdf_fuse_plain(depth, p, *fuse_args, work=work))
    diff = (tsdf - tplain).abs()
    fuse = dict(
        model=name, views=sn.N_VIEWS, res=res, work=work,
        voxels_over_1e6=int((diff > 1e-6).sum()),
        max_abs_err=float(diff.max()),
        ms=cuda_ms(lambda: fusion.tsdf_fuse(depth, p, *fuse_args), reps),
        plain_ms=tplain_ms, library_ms=None)
    # each voxel's centre and mean (13), each voxel-view's camera z (6),
    # in front of the camera its x, y and pixel (18), with a depth in the
    # image its sdf (2), averaged (3); the bytes: depths and poses in, the
    # grid out
    fuse["bound_ms"], fuse["bound_by"] = bound_ms(
        depth.numel() * 4 + p.numel() * 8 + tsdf.numel() * 4,
        13 * tsdf.numel() + 6 * work["voxel_views"] + 18 * work["in_front"]
        + 2 * work["sampled"] + 3 * work["averaged"], FP64_FLOPS)
    check(render["coverage_differs"] <= PREP_FLIP_SHARE * pixels
          and render["max_abs_err"] <= PREP_DEPTH_ERR,
          f"prep: render_depth against its plain version {render}")
    check(fuse["voxels_over_1e6"] <= PREP_FLIP_SHARE * tsdf.numel(),
          f"prep: tsdf_fuse against its plain version {fuse}")
    return dict(render_depth=render, tsdf_fuse=fuse)


def prep_outputs(out_root: str, name: str, keep_mesh: bool = False) -> dict:
    """One model's files read back and checked: its watertight mesh's open
    edges and faces, its simplified mesh's faces, its occupancy labels and
    scale, and (`keep_mesh`) the watertight mesh itself."""
    import numpy as np

    from rfdnet_tpu_torch.data.binvox import read_binvox
    from rfdnet_tpu_torch.meshing.mesh import TriMesh

    def path(sub, ext):
        return os.path.join(out_root, sub, PREP_CATID, name + ext)

    pc = np.load(path("pointcloud", ".npz"))
    pts = np.load(path("point", ".npz"))
    occ = np.unpackbits(pts["occupancies"])[:len(pts["points"])].astype(bool)
    with open(path("voxel/16", ".binvox"), "rb") as f:
        vox = read_binvox(f)
    wt = TriMesh.load(path("watertight_scaled", ".off"))
    simple = TriMesh.load(path("watertight_scaled_simplified", ".off"))
    check(pc["points"].shape == (100000, 3)
          and np.isfinite(pc["points"]).all()
          and pts["points"].shape == (100000, 3)
          and np.isfinite(pts["points"]).all() and 0 < occ.mean() < 1
          and vox.dims == [16, 16, 16] and vox.data.any()
          and len(wt.faces) > 0 and len(simple.faces) > 0,
          f"prep: {name}'s files: pointcloud {pc['points'].shape}, points "
          f"{pts['points'].shape} occupied {occ.mean()}, voxels "
          f"{vox.dims} {int(vox.data.sum())}, faces {len(wt.faces)} / "
          f"{len(simple.faces)}")
    return dict(open_edges=closed_meshes([wt]), faces=len(wt.faces),
                simplified_faces=len(simple.faces), occupancy=occ,
                scale=float(pts["scale"]),
                watertight=wt if keep_mesh else None)


def mesh_distance_voxels(a, b, voxel: float) -> float:
    """The largest distance between two meshes' vertices in voxels: vertex
    by vertex where their faces are equal, else each vertex's nearest one
    of the other mesh, both ways."""
    import numpy as np

    from rfdnet_tpu_torch.meshing.native import KDTree

    if np.array_equal(a.faces, b.faces) and a.vertices.shape == \
            b.vertices.shape:
        return float(np.abs(a.vertices - b.vertices).max()) / voxel
    d_ab, _ = KDTree(b.vertices).query(a.vertices)
    d_ba, _ = KDTree(a.vertices).query(b.vertices)
    return max(float(d_ab.max()), float(d_ba.max())) / voxel


def phase_prep(dev, reps: int = 3) -> dict:
    """The offline ShapeNet preparation (see the module docstring): both
    kernels against their plain versions at full width on two models, the
    CLI on the card over all of them (every file read back, watertight
    meshes closed, simplified ones below them), and on the CPU over one.
    Returns the kernel rows and the CLI run's launches."""
    from rfdnet_tpu_torch.meshing.mesh import TriMesh
    from rfdnet_tpu_torch.prep import shapenet

    with tempfile.TemporaryDirectory() as tmp:
        in_root = os.path.join(tmp, "in")
        names = prep_inputs(in_root)
        kernel_rows = {
            name: prep_kernel_rows(name, TriMesh.load(os.path.join(
                in_root, PREP_CATID, name, "model.off")), dev, reps)
            for name in (names[0], PREP_OPEN)}
        torch.cuda.empty_cache()
        out_root = os.path.join(tmp, "out")
        reset_launches()
        t0 = time.perf_counter()
        rc, printed = run_logged(lambda: shapenet.main(
            ["--in_root", in_root, "--out_root", out_root]))
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        results = [json.loads(line) for line in printed.splitlines()
                   if line.startswith('{"catid"')]
        check(rc == 0 and all(r["ok"] for r in results)
              and [r["model"] for r in results] == sorted(names),
              f"prep: the CLI's rc {rc}, models "
              f"{[(r['model'], r['ok']) for r in results]}")
        # the files read back in parallel: each watertight mesh is an OFF
        # of ~3M faces, seconds of parsing
        with ProcessPoolExecutor(
                8, mp_context=multiprocessing.get_context("spawn")) as pool:
            outputs = dict(zip(names, pool.map(
                prep_outputs, [out_root] * len(names), names,
                [name == names[0] for name in names])))
        open_edges = sum(o["open_edges"] for o in outputs.values())
        # one model again through the CLI's CPU route
        one = os.path.join(tmp, "in_one")
        shutil.copytree(os.path.join(in_root, PREP_CATID, names[0]),
                        os.path.join(one, PREP_CATID, names[0]))
        t1 = time.perf_counter()
        cpu_results = shapenet.run(one, os.path.join(tmp, "out_cpu"),
                                   device="cpu")
        cpu_s = time.perf_counter() - t1
        check(cpu_results[0][2], f"prep: the CPU route {cpu_results}")
        cpu = prep_outputs(os.path.join(tmp, "out_cpu"), names[0], True)
    card = outputs[names[0]]
    voxel = card["scale"] / PREP_RES  # a voxel, in the mesh's frame
    vs_cpu = dict(
        model=names[0],
        mesh_voxels=mesh_distance_voxels(card["watertight"],
                                         cpu["watertight"], voxel),
        faces_equal=bool(len(card["watertight"].faces) == len(
            cpu["watertight"].faces) and (card["watertight"].faces
                                          == cpu["watertight"].faces).all()),
        labels_agree=float((card["occupancy"] == cpu["occupancy"]).mean()),
        cpu_s=cpu_s)
    stage_ms = {r["model"]: r["stage_ms"] for r in results}
    row = dict(
        models=len(names), wall_s=wall_s, launches=launches,
        open_edges=open_edges,
        faces={m: o["faces"] for m, o in outputs.items()},
        simplified_faces={m: o["simplified_faces"]
                          for m, o in outputs.items()},
        stage_ms=stage_ms,
        stage_ms_mean={s: sum(ms[s] for ms in stage_ms.values()) / len(names)
                       for s in (*shapenet.STAGES, "total")},
        vs_cpu=vs_cpu, kernels=kernel_rows,
        printed_lines=len(printed.splitlines()))
    emit(phase="prep", **row)
    check(launches == {"fps": 0, "cbn_decode": 0, "render_depth": len(names),
                       "tsdf_fuse": len(names)}, f"prep: launches {launches}")
    check(open_edges == 0, f"prep: {open_edges} open edges")
    check(all(0 < row["simplified_faces"][m] < row["faces"][m]
              for m in names),
          f"prep: simplified faces {row['simplified_faces']}")
    check(vs_cpu["mesh_voxels"] <= PREP_VOXEL_TOL
          and vs_cpu["labels_agree"] >= PREP_LABEL_AGREE,
          f"prep: the card against the CPU {vs_cpu}")
    return dict(kernels=kernel_rows, launches=launches, models=len(names))


def read_scannet_prep(out_root: str, scene: str) -> dict:
    """The ScanNet prep's files of one scene and its class mean sizes."""
    import pickle

    import numpy as np

    with open(os.path.join(out_root, scene, "bbox.pkl"), "rb") as f:
        boxes = pickle.load(f)
    scan = np.load(os.path.join(out_root, scene, "full_scan.npz"))
    means = np.load(os.path.join(out_root, "scannet_means.npz"))["arr_0"]
    return dict(boxes=boxes, scan={k: scan[k] for k in scan.files},
                means=means)


def phase_prep_scannet() -> dict:
    """The ScanNet + Scan2CAD preparation (see the module docstring) on
    the card (its default device) and on the CPU. Returns the card run's
    launches."""
    import numpy as np

    from rfdnet_tpu_torch.data.synthetic import (
        RAW_SCENE,
        write_raw_scan2cad_scene,
    )
    from rfdnet_tpu_torch.prep import scannet

    vote_devices = set()
    accumulate = scannet.accumulate_votes

    def seen(box3D, vertices, *rest):  # the device the votes are made on
        vote_devices.add(vertices.device.type)
        return accumulate(box3D, vertices, *rest)

    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        _, paths = write_raw_scan2cad_scene(
            raw, object_points=PREP_SCAN_OBJECT_POINTS,
            floor_points=PREP_SCAN_FLOOR_POINTS)
        scannet.accumulate_votes = seen
        try:
            for route, extra in (("card", []), ("cpu", ["--device", "cpu"])):
                out_root = os.path.join(tmp, route)
                argv = ["--scan2cad", os.path.join(raw, "scan2cad.json"),
                        "--scans_root", paths["scans"], "--shapenet_root",
                        paths["shapenet"], "--label_tsv", paths["tsv"],
                        "--out_root", out_root, *extra]
                if route == "card":
                    reset_launches()
                t0 = time.perf_counter()
                rc, _ = run_logged(lambda: scannet.main(argv))
                seconds[route] = time.perf_counter() - t0
                if route == "card":
                    launches, card_devices = read_launches(), set(vote_devices)
                check(rc == 0, f"prep_scannet: the {route} run's rc {rc}")
                out[route] = read_scannet_prep(out_root, RAW_SCENE)
        finally:
            scannet.accumulate_votes = accumulate
    card, cpu = out["card"], out["cpu"]
    points = len(card["scan"]["mesh_vertices"])
    boxes_equal = len(card["boxes"]) == len(cpu["boxes"]) and all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(card["boxes"], cpu["boxes"]))
    votes_differ = int((card["scan"]["point_votes"]
                        != cpu["scan"]["point_votes"]).any(axis=1).sum())
    row = dict(
        points=points, boxes=len(card["boxes"]), vote_devices=sorted(
            card_devices), voted_points=int(
            card["scan"]["point_votes"][:, 0].sum()),
        boxes_equal=boxes_equal,
        means_equal=bool(np.array_equal(card["means"], cpu["means"])),
        scan_equal={k: bool(np.array_equal(card["scan"][k], cpu["scan"][k]))
                    for k in ("mesh_vertices", "instance_labels")},
        votes_differ=votes_differ, seconds=seconds, launches=launches)
    emit(phase="prep_scannet", **row)
    check(card_devices == {"cuda"} and row["boxes"] == 2
          and row["voted_points"] > 0 and boxes_equal and row["means_equal"]
          and all(row["scan_equal"].values())
          and votes_differ <= PREP_FLIP_SHARE * points,
          f"prep_scannet: the card against the CPU {row}")
    check(launches == {"fps": 0, "cbn_decode": 0},
          f"prep_scannet: launches {launches}")
    return launches


SANITY_SCENES, SANITY_POINTS, SANITY_BATCH = 8, 20000, 4
SANITY_STEPS = {"detection": 20, "completion": 10}
# the stage-2 freeze list of configs/iscnet_completion.yaml
SANITY_FROZEN = ("backbone", "voting", "detection")


def sanity_run(argv: list):
    """`sanity_train.main(argv)` in-process, with each step's loss terms
    kept: (metrics, the keys it printed, loss terms a step, launches)."""
    from rfdnet_tpu_torch.tools import sanity_train as st

    histories, train = [], st.train

    def keep(*args, **kw):
        histories.append(train(*args, **kw))
        return histories[-1]

    st.train = keep
    try:
        reset_launches()
        metrics, printed = run_logged(lambda: st.main(argv))
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        st.train = train
    keys = [line.rsplit(":", 1)[0] for line in printed.splitlines()
            if "@0.25:" in line or "voxel IoU:" in line]
    return metrics, keys, histories[0], launches


def phase_sanity() -> dict:
    """The learning check's CLI (`rfdnet_tpu_torch.tools.sanity_train`)
    in-process at a small size, in a temporary directory: SANITY_STEPS
    detection steps at batch 4 on 8 synthetic 20000-point scenes with
    `--save-to`, then completion steps from those weights
    (`--finetune-from`) with backbone, voting and detection frozen, each
    scored by the Tester on the tool's 4 held-out scenes. Checks: every
    loss term finite; every frozen parameter bit-equal in the two saved
    files; the printed keys those the JAX tool prints (mAP and AR @0.25,
    and in the completion phase one voxel IoU a class with a valid slot:
    after 30 steps there may be none); FPS
    launches 5 a step and 5 a scored scene, CBN 0 in detection and 2 a
    scored scene in completion (the completion loss and the 16^3 voxels).
    Returns the launches of each stage's run."""
    import numpy as np

    from rfdnet_tpu_torch.config import CLASS2TYPE
    from rfdnet_tpu_torch.tools import sanity_train as st

    tmp = tempfile.mkdtemp(prefix="sanity_")
    det, comp = os.path.join(tmp, "det"), os.path.join(tmp, "comp")
    common = ["--scenes", str(SANITY_SCENES), "--batch", str(SANITY_BATCH),
              "--points", str(SANITY_POINTS)]
    runs, launches = {}, {}
    try:
        for phase, extra in (
                ("detection", ["--save-to", det]),
                ("completion", ["--finetune-from", det, "--freeze",
                                ",".join(SANITY_FROZEN), "--save-to", comp])):
            steps = SANITY_STEPS[phase]
            t0 = time.perf_counter()
            metrics, keys, history, counts = sanity_run(
                [*common, "--phase", phase, "--steps", str(steps), *extra])
            seconds = time.perf_counter() - t0
            finite = all(np.isfinite(v) for h in history for v in h.values())
            check(len(history) == steps and finite,
                  f"sanity {phase}: {len(history)} steps, finite {finite}")
            voxel = keys[2:]
            check(keys[:2] == ["mAP @0.25", "AR @0.25"]
                  and all(k.endswith(" voxel IoU") and k.removesuffix(
                      " voxel IoU") in CLASS2TYPE.values() for k in voxel)
                  and (phase == "completion" or not voxel)
                  and keys == list(st.printed(metrics)),
                  f"sanity {phase}: printed keys {keys}")
            val = 4  # the tool's held-out scenes
            want = {"fps": 5 * (steps + val),
                    "cbn_decode": 2 * val if phase == "completion" else 0,
                    "adam": steps}
            check(counts == want, f"sanity {phase}: launches {counts}, "
                  f"expected {want}")
            launches[f"sanity_{phase}"] = counts
            runs[phase] = dict(
                steps=steps, seconds=seconds, launches=counts,
                first=history[0], last=history[-1],
                metrics={k: metrics[k] for k in keys})
        with np.load(det + ".npz") as a, np.load(comp + ".npz") as b:
            frozen = [k for k in a.files if k.startswith("params/")
                      and k.split("/")[1] in SANITY_FROZEN]
            unequal = [k for k in frozen if not np.array_equal(a[k], b[k])]
        check(frozen and not unequal,
              f"sanity: frozen parameters changed in stage 2: {unequal}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="sanity", scenes=SANITY_SCENES, points=SANITY_POINTS,
         batch=SANITY_BATCH, frozen_parameters_equal=len(frozen), runs=runs)
    return launches


# the FPS launches of one call of each stage of the train-step profile (by
# its `--stages` key): five a train step (SA1-4, seed_fps), four the
# backbone, one the proposal head's seed_fps
PROFILE_FPS = {"full_step": 5, "det_step": 5, "backbone_fwd": 4,
               "backbone_bwd": 4, "fps_sa1": 1, "ballq_sa1": 0,
               "vote_prop": 1, "skip_prop": 0, "onet_loss": 0}
# the Adam launches of one call of each stage: one a train step, none in
# the stages that stop before the update
PROFILE_ADAM = {"full_step": 1, "det_step": 1}


def phase_profile_train() -> dict:
    """`python -m rfdnet_tpu_torch.tools.profile_train --iters 2 --trace`
    in-process at its full size (batch 8 x 80000 points): every stage a
    positive time, FLOPs counted for every stage but FPS's and ball
    query's (`full_step`'s nonzero), each stage's FPS launches a call as
    PROFILE_FPS says, no CBN launch (train mode decodes layer by
    layer) and the Adam launches PROFILE_ADAM says, the trace written
    with device events. Returns each stage's launches a call."""
    from rfdnet_tpu_torch.tools import profile_train as pt

    tmp = tempfile.mkdtemp(prefix="profile_train_")
    trace = os.path.join(tmp, "trace.json")
    try:
        rows, printed = run_logged(lambda: pt.main(
            ["--iters", "2", "--trace", trace]))
        traced = json.loads(next(
            line for line in printed.splitlines()
            if line.startswith('{"trace_full_step"')))["trace_full_step"]
        check(os.path.getsize(trace) > 0 and traced["device_events"] > 0,
              f"profile_train: trace {traced}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = pt.stage_names(pt.BATCH, pt.POINTS)
    check([r["stage"] for r in rows] == list(names.values()),
          f"profile_train: stages {[r['stage'] for r in rows]}")
    for key, r in zip(names, rows):
        check(r["ms"] > 0 and (r["flops"] is None if key in pt.NO_FLOPS
                               else r["flops"] > 0),
              f"profile_train: {r}")
        check(r["launches"] == {"fps": PROFILE_FPS[key], "cbn_decode": 0,
                                "adam": PROFILE_ADAM.get(key, 0)},
              f"profile_train {key}: launches {r['launches']}")
    emit(phase="profile_train", rows=rows, trace={
        k: traced[k] for k in ("window_ms", "device_busy_ms", "idle_share",
                               "device_events", "top")})
    return {f"profile_{key}": r["launches"] for key, r in zip(names, rows)}


# the protocol run at a small depth: the generator's scenes, 1 variant a
# class, 120000 raw points (its default); one epoch a stage at batch 4
PROTOCOL_TRAIN, PROTOCOL_VAL, PROTOCOL_BATCH = 8, 2, 4


def phase_protocol() -> dict:
    """The protocol dataset and the three-stage protocol run at full width
    and a small depth, in a temporary directory:
    `rfdnet_tpu_torch.tools.gen_synthetic_dataset` (in-process) writes
    PROTOCOL_TRAIN + PROTOCOL_VAL scenes, then
    `rfdnet_tpu_torch.tools.protocol_run.main` (in-process) trains each
    stage one epoch at batch 4 in a `python -m rfdnet_tpu_torch --mode
    train` subprocess and runs the test protocol (mesh mAP) in this
    process. Checks: every chunk exited 0 at its first try; each stage's
    run directory logged `train epoch 0 done` and its schedule row; stage
    2 and stage 3 finetuned from their predecessor's `.npz` and the test
    loaded stage 3's, with no weight path missing; `metrics.json` holds
    finite mAP and mesh mAP at 0.25 and 0.5, each voxel IoU a class's;
    the test's launches FPS 5 and CBN 3 a scene (counts set to 0 just
    before `main`; the chunks' launches are their processes'). Returns the
    test stage's launches."""
    import numpy as np

    from rfdnet_tpu_torch.config import CLASS2TYPE
    from rfdnet_tpu_torch.tools import gen_synthetic_dataset as gen
    from rfdnet_tpu_torch.tools import protocol_run as pr

    tmp = tempfile.mkdtemp(prefix="protocol_")
    root, out = os.path.join(tmp, "ds"), os.path.join(tmp, "out")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        gen.main(["--out", root, "--train", str(PROTOCOL_TRAIN), "--val",
                  str(PROTOCOL_VAL), "--variants", "1"])
        gen_s = time.perf_counter() - t0
        os.chdir(tmp)
        reset_launches()
        t0 = time.perf_counter()
        results, printed = run_logged(lambda: pr.main([
            "--root", root, "--out", out, "--epochs", "1", "1", "1",
            "--batch", str(PROTOCOL_BATCH), "--chunk", "1"]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        logs = {}
        for key, stage in (("detection", "stage1_detection"),
                           ("completion", "stage2_completion"),
                           ("joint", "stage3_joint")):
            with open(os.path.join(pr._run_dir(os.path.join(out, stage)),
                                   "log.txt")) as f:
                logs[key] = f.read()
        with open(os.path.join(out, "metrics.json")) as f:
            saved = json.load(f)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    w = results["weights"]
    for key, log in logs.items():
        check("train epoch 0 done" in log
              and [r["epoch"] for r in results["stages"][key]["schedule"]]
              == [0], f"protocol {key}: no epoch 0 or schedule row")
        chunks = results["chunks"][key]
        check([(c["epochs"], c["tries"]) for c in chunks] == [(1, 1)],
              f"protocol {key}: chunks {chunks}")
    check(f"finetuned from {w['completion']}.npz" in logs["completion"]
          and f"finetuned from {w['joint']}.npz" in logs["joint"]
          and f"loaded weights {w['test']}.npz" in printed,
          f"protocol: a stage did not load its predecessor {w}")
    check("not found" not in printed + "".join(logs.values()),
          "protocol: a weight path not found")
    metrics = saved["metrics"]
    voxel = sorted(k for k in metrics if k.endswith(" voxel IoU"))
    check(all(np.isfinite(metrics[k]) for k in (
        "mAP @0.25", "mAP @0.5", "mAP_mesh @0.25", "mAP_mesh @0.5"))
          and all(k.removesuffix(" voxel IoU") in CLASS2TYPE.values()
                  and 0 <= metrics[k] <= 1 for k in voxel),
          f"protocol: metrics {sorted(metrics)}")
    want = {"fps": 5 * PROTOCOL_VAL, "cbn_decode": 3 * PROTOCOL_VAL}
    check(launches == want, f"protocol: test launches {launches}, "
          f"expected {want}")
    emit(phase="protocol", train=PROTOCOL_TRAIN, val=PROTOCOL_VAL,
         batch=PROTOCOL_BATCH, points=pr.N_POINTS, generate_s=gen_s,
         run_s=run_s, chunks=results["chunks"], epoch_s=results["epoch_s"],
         test_s=results["test_s"],
         test_s_per_scene=results["test_s"] / PROTOCOL_VAL,
         launches=launches, voxel_iou_classes=len(voxel),
         metrics={k: metrics[k] for k in (
             "mAP @0.25", "mAP @0.5", "mAP_mesh @0.25", "mAP_mesh @0.5",
             *voxel)})
    return launches


# the Tester's four ways for `sanity_modes`: f32, and each bf16 mode
SANITY_MODES = {
    "f32": {},
    "decoder_bf16": {"data": {"decoder_bf16": True}},
    "decoder_impl_pallas": {"generation": {"decoder_impl": "pallas"}},
    "mlp_bf16": {"data": {"mlp_bf16": True}},
}


def sanity_modes(weights: str, points: int = 20000, scenes: int = 32,
                 grid_res: int = 32) -> dict:
    """The accuracy of the bf16 modes with trained weights: the completion
    weights at `weights` (`<weights>.npz`, from `sanity_train --save-to`)
    scored by the Tester (the tool's config) on the tool's held-out scenes
    (drawn as the tool draws them for `scenes` train scenes) four ways
    (SANITY_MODES), and each scene's generation at a `grid_res`^3 dense
    grid: mAP and AR @0.25, voxel IoU by class, and against f32 the share
    of grid voxels whose occupancy (logit >= logit(threshold)) differs, and
    that of the 16^3 shape voxels, over the slots that hold the same
    proposal in both runs. `generation.decoder_impl: pallas` changes only
    the grid decode, so its Tester metrics equal f32's by construction.
    Run on the card with one JSON line a mode, e.g.
    `python3 -c "import chip_smoke; chip_smoke.sanity_modes('w/comp')"`."""
    import numpy as np

    from rfdnet_tpu_torch.config import eval_config, update_recursive
    from rfdnet_tpu_torch.eval.tester import decoder_impl_dtype
    from rfdnet_tpu_torch.tools import sanity_train as st
    from rfdnet_tpu_torch.weights import load_npz

    dev = torch.device("cuda", 0)
    _, val = st.make_scenes(np.random.RandomState(0), scenes, points)
    out, ref = {}, None
    for mode, over in SANITY_MODES.items():
        cfg = st.tester_config(points, "completion")
        update_recursive(cfg, over)
        d, gen_cfg = cfg["data"], cfg["generation"]
        model = st.build_model(
            "completion", dev, decoder_bf16=bool(d.get("decoder_bf16")),
            mlp_dtype=torch.bfloat16 if d.get("mlp_bf16") else None)
        load_npz(model, weights + ".npz")
        model.eval()
        reset_launches()
        t0 = time.perf_counter()
        metrics = st.score(cfg, model, val, log=lambda _: None)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        iso = float(np.log(d["threshold"] / (1 - d["threshold"])))
        ec = eval_config(cfg)
        runs = []
        for scene in val:
            data = {k: torch.from_numpy(scene[k]).to(dev) for k in (
                "point_clouds", "center_label", "box_label_mask",
                "sem_cls_label", "point_instance_labels",
                "object_instance_labels", "object_points",
                "object_points_occ")}
            g = model.generate(
                data, nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
                dump_threshold=gen_cfg["dump_threshold"],
                remove_empty_box=ec["remove_empty_box"],
                decode_grid_res=grid_res,
                grid_mxu_dtype=decoder_impl_dtype(gen_cfg))
            runs.append(dict(
                ids=g["gen"]["proposal_ids"][..., 0].reshape(-1).cpu().numpy(),
                valid=g["gen"]["valid"].reshape(-1).cpu().numpy().astype(bool),
                grid=(g["grids"] >= iso).cpu().numpy(),
                voxels=np.unpackbits(g["shape_voxels_bits"].cpu().numpy(),
                                     axis=-1)))
        row = dict(mode=mode, seconds=seconds, launches=launches,
                   metrics=st.printed(metrics))
        if ref is None:
            ref = runs
        else:
            same = [r["valid"] & f["valid"] & (r["ids"] == f["ids"])
                    for r, f in zip(runs, ref)]
            row.update(
                slots_compared=int(sum(s.sum() for s in same)),
                slots_valid=int(sum(r["valid"].sum() for r in runs)),
                grid_differ_share=float(
                    sum((r["grid"][s] != f["grid"][s]).sum()
                        for r, f, s in zip(runs, ref, same))
                    / max(1, sum(s.sum() for s in same) * grid_res ** 3)),
                voxel16_differ_share=float(
                    sum((r["voxels"][s] != f["voxels"][s]).sum()
                        for r, f, s in zip(runs, ref, same))
                    / max(1, sum(s.sum() for s in same) * 16 ** 3)))
        out[mode] = row
        print(json.dumps({"sanity_mode": row}), flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def kernel_summary(fps_rows, fps_batch, fps_flag_off, cbn_rows, launches,
                   test_cbn, mise_cbn, prep, adam):
    """One entry per kernel. `launches` and the times are the main path's
    (to the grids): FPS summed over its five calls there, the CBN decoder
    in the test config's f32 mode; `launches_by_path` has every driven
    path's count (the test path's a scene, `train` a full-width train
    step, `train_val` its val step, `train_<route>_workers` a batch-2
    train step of the loader phase, `mesh_options` a scene with refine,
    simplify and normals, `modules_msg` one `SetAbstractionMSG` call,
    `mlp_bf16` a scene of the bf16 chains, `serve_b8` / `serve_b1` /
    `serve_group` a served batch of 8, a batch-1 call and the batch of 8
    in a one-rank group, `point_shard_bucketed` one `fps_bucketed` call,
    `ddp_train` / `ddp_val` a train and a val step in a one-rank group,
    `sanity_detection` / `sanity_completion` a run of the learning check's
    CLI, `profile_<stage>` one call of a train-step profile stage,
    `protocol_test` the protocol run's test stage over its val scenes),
    `detection_ms` the FPS calls of the
    detection path (SA1-4 and vote_fps), the FPS entry's `train_batch`
    its five calls of a train step at batch 8 and `flag_off` the kernel
    with `skip_near_origin=False` at SA1's shape at batch 1 and 8 and at
    an `fps_bucketed` slab (`launches` a call), and the CBN entry's
    `test_shapes` the kernel at the test path's two other decodes, at
    the val step's (`train_val_t2048`, 80 proposals) and at a served batch
    of 8 scenes' (`serve_b8`, 512 proposals), and `mise_shapes` at
    each level of a MISE scene's octree (`launches` a scene, `points` the
    real points the bound counts). The CBN entry's launches are both
    kernels'; the `cbn_decode_bf16` entry is the bf16 kernel's: its
    `launches` a scene of the demo path at `data.decoder_bf16`
    (`decoder_bf16_demo`; `decoder_bf16_serve_b8` a served batch,
    `decoder_bf16_tester_pallas` a Tester scene at `decoder_impl:
    pallas`; 0 on the f32 paths), its times at 64 x 32768, and `shapes`
    at every shape of the paths, on their captured operands. The
    `render_depth` and `tsdf_fuse` entries are the prep path's (`prep`:
    the CLI over `models` models, one launch of each a model; 0 on every
    other path, the ScanNet prep's `prep_scannet` among them): times,
    errors and bounds at full width on the first demo mesh, and `shapes`
    on both models of the phase. The `adam` entry's `launches` are a
    full-width train step's, its times and errors `phase_adam`'s (the
    `profile_*` paths count FPS and CBN alone, `profile_train.launches_of`,
    so they read 0 there)."""
    f32, bf16 = cbn_rows["float32"], cbn_rows["bfloat16"]
    main = [r for r in fps_rows if r["name"] != "vote_fps"]
    detection = [r for r in fps_rows if r["name"] != "seed_fps"]

    def by_path(kernel):
        return {path: counts[kernel] for path, counts in launches.items()}

    return [
        dict(name="fps", route="cuda", source="rfdnet_tpu_torch/csrc/fps.cu",
             replaces="rfdnet_tpu/ops/fps.py:121",
             launches=launches["main"]["fps"],
             launches_by_path=by_path("fps"),
             max_abs_err=max(r["max_abs_err"] for r in fps_rows),
             ms=sum(r["ms"] for r in main),
             plain_ms=sum(r["plain_ms"] for r in main),
             bound_ms=sum(r["bound_ms"] for r in main),
             bound_by=main[0]["bound_by"], library_ms=None,
             chain_bound_ms=sum(r["chain_bound_ms"] for r in main),
             prev_ms=sum(r["prev_ms"] for r in main),
             detection_ms=sum(r["ms"] for r in detection),
             train_batch=dict(
                 b=fps_batch[0]["b"], ms=sum(r["ms"] for r in fps_batch),
                 plain_ms=sum(r["plain_ms"] for r in fps_batch),
                 bound_ms=sum(r["bound_ms"] for r in fps_batch),
                 chain_bound_ms=sum(r["chain_bound_ms"] for r in fps_batch),
                 max_abs_err=max(r["max_abs_err"] for r in fps_batch),
                 active_clusters={r["name"]: r["active_clusters"]
                                  for r in fps_batch}),
             flag_off={r["name"]: {k: r[k] for k in (
                 "b", "n", "npoint", "launches", "max_abs_err", "ms",
                 "ms_flag_on", "plain_ms", "bound_ms", "bound_by",
                 "chain_bound_ms")}
                 for r in fps_flag_off["rows"]}),
        dict(name="cbn_decode", route="cuda",
             source="rfdnet_tpu_torch/csrc/cbn_decoder.cu",
             replaces="rfdnet_tpu/ops/cbn_decoder.py:160",
             launches=launches["main"]["cbn_decode"],
             launches_by_path=by_path("cbn_decode"),
             max_abs_err=f32["max_abs_err"],
             ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
             bound_by=f32["bound_by"], library_ms=f32["library_ms"],
             test_shapes={name: {k: row[k] for k in (
                 "nb", "t", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")} for name, row in test_cbn.items()},
             mise_shapes={name: {k: row[k] for k in (
                 "level", "nb", "t", "points", "launches", "max_abs_err",
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                 for name, row in mise_cbn.items()}),
        dict(name="cbn_decode_bf16", route="cuda",
             source="rfdnet_tpu_torch/csrc/cbn_decoder_bf16.cu",
             replaces="rfdnet_tpu/ops/cbn_decoder.py:160",
             launches=launches["decoder_bf16_demo"]["cbn_decode_bf16"],
             launches_by_path={path: counts.get("cbn_decode_bf16", 0)
                               for path, counts in launches.items()},
             max_abs_err=bf16["max_abs_err"], ms=bf16["ms"],
             plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
             bound_by=bf16["bound_by"], library_ms=bf16["library_ms"],
             differ_share=bf16["differ_share"],
             differ_share_limit=BF16_DIFFER_SHARE,
             shapes={name: {k: row[k] for k in (
                 "nb", "t", "points", "max_abs_err", "scale",
                 "within_1e3_scale", "err_vs_plain_f32", "err_vs_plain_cublas",
                 "plain_order_spread", "differ_share", "plain_differ_share",
                 "mistake_differ_share", "plain_f32_differ_share", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")}
                 for name, row in CBN_BF16_ROWS.items()}),
        *(prep_entry(name, prep, launches) for name in (
            "render_depth", "tsdf_fuse")),
        dict(name="adam", route="cuda",
             source="rfdnet_tpu_torch/csrc/adam.cu", replaces=None,
             launches=launches["train"].get("adam", 0),
             launches_by_path={path: counts.get("adam", 0)
                               for path, counts in launches.items()},
             **{k: adam[k] for k in (
                 "leaves", "elements", "chunks", "max_abs_err", "ms",
                 "step_ms", "step_host_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "library_max_abs_err")}),
    ]


def prep_entry(name: str, prep: dict, launches: dict) -> dict:
    """The summary entry of one of the prep path's kernels."""
    replaces = {"render_depth": "rfdnet_tpu/meshing/src/prep.cpp:310",
                "tsdf_fuse": "rfdnet_tpu/meshing/src/prep.cpp:360"}[name]
    rows = {model: r[name] for model, r in prep["kernels"].items()}
    first = next(iter(rows.values()))
    return dict(
        name=name, route="cuda", source=f"rfdnet_tpu_torch/csrc/{name}.cu",
        replaces=replaces, launches=launches["prep"][name],
        launches_by_path={path: counts.get(name, 0)
                          for path, counts in launches.items()},
        models=prep["models"], max_abs_err=first["max_abs_err"],
        ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=None, shapes=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import rfdnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    launch_recorder()  # the launch counters count from here
    seconds, done = part_timer()  # the host-clock seconds of each phase
    phase_device()
    done("device")
    cfg, data, model = slice_setup(dev)
    with torch.no_grad():
        votes = model.detect(data["point_clouds"])[0]["vote_xyz"].contiguous()
    fps_rows, fps_batch, fps_flag_off = phase_fps(
        data["point_clouds"][..., :3].contiguous(), votes)
    done("fps")
    cbn_rows = phase_cbn(model, dev)
    torch.cuda.empty_cache()
    done("cbn_decode")
    adam = phase_adam(dev)
    torch.cuda.empty_cache()
    done("adam")
    launches, grids, valid, meshes = phase_slice(model, data, cfg)
    phase_mesh(model, cfg, grids, valid, meshes)
    phase_reference(model, cfg)
    done("slice_mesh_reference")
    launches["mise"], mise_cbn = phase_mise(model, data)
    torch.cuda.empty_cache()
    done("mise")
    launches["mesh_options"] = phase_mesh_options(model, data)
    done("mesh_options")
    modules = phase_modules(model, data)
    launches["modules_msg"], launches["mlp_bf16"] = (modules["msg"],
                                                      modules["mlp_bf16"])
    torch.cuda.empty_cache()
    done("modules")
    serve, serve_cbn, serve_ms = phase_serve(model, cfg, dev)
    for name, counts in serve.items():
        launches[f"serve_{name}"] = counts
    torch.cuda.empty_cache()
    done("serve")
    launches.update(phase_decoder_bf16(model, cfg, data, serve_ms))
    torch.cuda.empty_cache()
    done("decoder_bf16")
    launches["point_shard_bucketed"] = phase_point_shard(model, data)
    done("point_shard")
    launches["demo"] = phase_demo()
    launches["detection"] = phase_detection(dev)
    done("demo_detection")
    launches["test"], test_cbn = phase_tester(dev)
    done("tester")
    (launches["train"], launches["train_val"], train_cbn,
     loader_launches) = phase_train(dev)
    for route, counts in loader_launches.items():
        launches[f"train_{route}_workers"] = counts
    test_cbn["train_val_t2048"] = train_cbn
    test_cbn["serve_b8"] = serve_cbn
    done("train")
    launches["ddp_train"], launches["ddp_val"] = phase_ddp(dev)
    done("ddp")
    prep = phase_prep(dev)
    launches["prep"] = prep["launches"]
    done("prep")
    launches["prep_scannet"] = phase_prep_scannet()
    done("prep_scannet")
    launches.update(phase_sanity())
    done("sanity")
    launches.update(phase_profile_train())
    torch.cuda.empty_cache()
    done("profile_train")
    launches["protocol_test"] = phase_protocol()
    done("protocol")
    emit(phase="timing", seconds=seconds, total_s=sum(seconds.values()))

    print(json.dumps({"kernels": kernel_summary(
        fps_rows, fps_batch, fps_flag_off, cbn_rows, launches, test_cbn,
        mise_cbn, prep, adam)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
