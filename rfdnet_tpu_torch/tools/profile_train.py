"""Per-stage device time of the training step.

The port's counterpart of `tools/profile_train.py`: times each stage of
the completion-phase train step at the reference's `ISCNet.yaml` size
(batch 8 x 80000 points, eight objects a synthetic scene from
`RandomState(0)`, the JAX package's init) and prints one line a stage and
a table. The stages, with the names and `--stages` filter of the JAX tool
(filter key -> printed name):
  full_step -> full_step          the train step: forward, loss, backward,
                                  Adam (`train.trainer.train_step`)
  det_step -> det_step            the same of the detection-phase model
  backbone_fwd -> backbone_fwd    Pointnet2Backbone alone, forward
  backbone_bwd -> backbone_fwd+bwd   and its backward
  fps_sa1 -> fps_sa1(8x80k)       the FPS kernel at SA1's shape
  ballq_sa1 -> ballq_sa1          ball query at SA1's shape (2048 centres,
                                  r 0.2, 64 samples)
  vote_prop -> vote_prop_bwd      voting + proposal head, forward and
                                  backward (1024 seeds, 256 proposals)
  skip_prop -> skip_prop_bwd      skip propagation, forward and backward
                                  (10 proposals a scene)
  onet_loss -> onet_loss_bwd      ONet's loss, forward and backward
                                  (80 x 2048 occupancy points)
Forward-only stages run in train mode (batch statistics) without autograd.

Timing: CUDA events around `--iters` chained calls after one warm-up call,
the median of 3 such windows, divided by `--iters` (on the CPU the host
clock). Eager PyTorch runs each call as it is issued: it neither hoists
loop-invariant work out of a loop nor drops an unused result, so the JAX
tool's input perturbation and null-program subtraction have no counterpart
here.

FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one call of the
stage, forward and backward. It counts the matrix products and
convolutions (2 x m x n x k a product): the MLPs, heads and decoder, and
also the distance products of ball query and three-NN (k = 3). It does
not count FPS, gathers or elementwise work, so the stages that are only
FPS or ball query print null. A stage whose count fails raises; a stage
that should have products and counts none raises too. TF/s are given
against the H100's peaks (NVIDIA's H100 SXM data sheet): 67 TFLOP/s f32
outside the tensor cores, which the f32 step runs (TF32 stays off in the
port), and with `--bf16` also 989 TFLOP/s, the bf16 tensor-core rate of
the shared MLPs' products (`data.mlp_bf16`, `mlp_dtype=torch.bfloat16`).

Each stage also prints its kernel launches in one call (the counters
`ops.fps.launches`, `ops.cbn_decode.launches` and `ops.adam.launches` of
a `recording()`) and
the spans that one more call opened (`spans`: device ms of each, on the
CPU host ms; the train step's `train.*` and the model's `iscnet.*`), and
the card's name and power limit (`nvidia-smi`) head the output. `--trace PATH` writes one `torch.profiler` trace (CPU and
CUDA activity, Chrome format) of a `full_step` call to PATH and prints its
device-busy share and its kernels by device time.

Run: `python -m rfdnet_tpu_torch.tools.profile_train [--iters 8] [--bf16]
[--stages full_step fps_sa1 ...] [--trace PATH] [--device cpu]`; on the
current CUDA card unless `--device` says otherwise (without a card and
without `--device cpu` it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import resolve_device
from ..config import MEAN_SIZE_ARR
from ..data.synthetic import synthetic_scene_batch
from ..models.backbone import Pointnet2Backbone
from ..models.common import set_bn_momentum, set_compute_dtype
from ..models.iscnet import ISCNet
from ..models.occnet import ONet
from ..models.proposal import ProposalModule
from ..models.skip_propagation import SkipPropagation
from ..models.voting import VotingModule
from ..ops import ball_query, furthest_point_sample
from ..train.loop import to_device
from ..train.trainer import Adam, freeze, make_optimizer_with_specs, train_step
from ..utils import profiling
from ..weights import init_seeded

BATCH, POINTS = 8, 80_000
NUM_OBJECTS = 8
PROPOSALS = 10  # completion_limit_in_train
OCC_POINTS = 2048
LR, BN_MOMENTUM = 1e-3, 0.5
REPEATS = 3
F32_PEAK, BF16_PEAK = 67e12, 989e12


def stage_names(batch: int = BATCH, points: int = POINTS) -> dict:
    """{`--stages` key: printed name}, in the JAX tool's order."""
    return {
        "full_step": "full_step", "det_step": "det_step",
        "backbone_fwd": "backbone_fwd", "backbone_bwd": "backbone_fwd+bwd",
        "fps_sa1": f"fps_sa1({batch}x{points // 1000}k)",
        "ballq_sa1": "ballq_sa1", "vote_prop": "vote_prop_bwd",
        "skip_prop": "skip_prop_bwd", "onet_loss": "onet_loss_bwd",
    }


# the stages that are only FPS or ball query: no products to count
NO_FLOPS = ("fps_sa1", "ballq_sa1")


def parse_args(argv=None):
    p = argparse.ArgumentParser("profile_train")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--stages", nargs="*", default=None,
                   help="subset of stage names to run")
    p.add_argument("--trace", default=None,
                   help="write a torch.profiler trace of full_step here")
    p.add_argument("--device", default=None,
                   help="the device to profile (default: the current CUDA "
                        "card)")
    return p.parse_args(argv)


def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them, or None
    where there is no nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, iters: int, device: torch.device,
             repeats: int = REPEATS) -> float:
    """Milliseconds a call of fn: the median over `repeats` windows of
    `iters` chained calls (CUDA events on a card, else the host clock).
    The caller has made the warm-up call."""
    sync(device)
    runs = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(runs)


def count_flops(fn) -> int:
    """The FLOPs of one call of fn that `FlopCounterMode` counts (forward
    and backward); raises when it counts none."""
    with FlopCounterMode(display=False) as counter:
        fn()
    flops = counter.get_total_flops()
    if flops <= 0:
        raise RuntimeError("profile_train: the FLOP counter counted no "
                           "product in a stage that has some")
    return int(flops)


def launches_of(fn, device: torch.device) -> dict:
    """The FPS, CBN and Adam kernel launches of one call of fn."""
    with profiling.recording() as rec:
        fn()
        sync(device)
    return {"fps": rec.counter("ops.fps.launches"),
            "cbn_decode": rec.counter("ops.cbn_decode.launches"),
            "adam": rec.counter("ops.adam.launches")}


def spans_of(fn) -> dict:
    """{span name: ms} of the spans that one call of fn opened: the device
    ms of each (summed over its calls), the host ms without a card."""
    with profiling.recording() as rec:
        fn()
    return {name: row["host_ms"] if row["device_ms"] is None
            else row["device_ms"]
            for name, row in rec.table()["spans"].items()}


def grads_of(loss: torch.Tensor, module: torch.nn.Module) -> tuple:
    """d loss / d parameters of `module` (no `.grad` accumulation; None
    for a parameter the loss does not reach)."""
    return torch.autograd.grad(loss, [p for p in module.parameters()
                                      if p.requires_grad], allow_unused=True)


def seeded(module: torch.nn.Module, device) -> torch.nn.Module:
    """`module` with the JAX package's init, on `device`, in train mode."""
    init_seeded(module, 0, noise=0.0)
    return module.to(device).train()


class Stages:
    """The stages' calls on one synthetic batch, each built when asked
    for (`call(key)`). `widths` (c_dim, hidden_dim, z_dim) override the
    models' defaults."""

    def __init__(self, device, batch: int = BATCH, points: int = POINTS,
                 bf16: bool = False, widths: dict | None = None):
        self.device, self.batch, self.points = device, batch, points
        self.widths = dict(widths or {})
        self.mlp_dtype = torch.bfloat16 if bf16 else None
        self.data = to_device(synthetic_scene_batch(
            np.random.RandomState(0), batch_size=batch, num_points=points,
            num_objects=NUM_OBJECTS, mean_size_arr=MEAN_SIZE_ARR), device)
        self.pc = self.data["point_clouds"]
        self.xyz = self.pc[..., :3].contiguous()
        self.gen = torch.Generator(device=device).manual_seed(0)
        self.c_dim = self.widths.get("c_dim", 512)

    def call(self, key: str):
        return getattr(self, key)()

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device)

    def _step(self, phase: str):
        model = seeded(ISCNet(mean_size_arr=MEAN_SIZE_ARR, phase=phase,
                              mlp_dtype=self.mlp_dtype, **self.widths),
                       self.device)
        set_bn_momentum(model, BN_MOMENTUM)
        opt = Adam(freeze(model, ()), make_optimizer_with_specs({}, {}))
        return lambda: train_step(model, opt, self.data, LR,
                                  generator=self.gen)

    def full_step(self):
        return self._step("completion")

    def det_step(self):
        return self._step("detection")

    def _backbone(self):
        bb = Pointnet2Backbone(input_feature_dim=1)
        if self.mlp_dtype is not None:
            set_compute_dtype(bb, self.mlp_dtype)
        return seeded(bb, self.device)

    def backbone_fwd(self):
        bb, pc = self._backbone(), self.pc

        def fwd():
            with torch.no_grad():
                return bb(pc)["fp2_features"]
        return fwd

    def backbone_bwd(self):
        bb, pc = self._backbone(), self.pc
        return lambda: grads_of(bb(pc)["fp2_features"].float().sum(), bb)

    def fps_sa1(self):
        return lambda: furthest_point_sample(self.xyz, 2048)

    def ballq_sa1(self):
        centers = self.xyz[:, :2048].contiguous()
        return lambda: ball_query(self.xyz, centers, 0.2, 64)

    def vote_prop(self):
        seeds_xyz = self.xyz[:, :1024].contiguous()
        seeds_f = self.zeros(self.batch, 1024, 256)
        vote = seeded(VotingModule(), self.device)
        prop = seeded(ProposalModule(num_class=8, num_heading_bin=12,
                                     num_size_cluster=8, num_proposal=256,
                                     sampling="seed_fps"), self.device)
        both = torch.nn.ModuleList([vote, prop])

        def vote_prop_bwd():
            vx, vf = vote(seeds_xyz, seeds_f)
            vf = vf / torch.clamp(torch.linalg.vector_norm(
                vf, dim=-1, keepdim=True), min=1e-8)
            _, feats = prop(vx, vf, {"seed_xyz": seeds_xyz})
            return grads_of(feats.sum(), both)
        return vote_prop_bwd

    def skip_prop(self):
        B, P = self.batch, PROPOSALS
        sp = seeded(SkipPropagation(
            c_dim=self.c_dim, hidden_dim=self.widths.get("hidden_dim", 512),
            input_feature_dim=1), self.device)
        box_xyz = self.xyz[:, :P].contiguous()
        args = (box_xyz, self.zeros(B, P), self.zeros(B, P, 128), self.pc,
                self.zeros(B, self.points), self.zeros(B, P))

        def skip_prop_bwd():
            feats, mask_loss = sp(*args)
            return grads_of(feats.sum() + mask_loss, sp)
        return skip_prop_bwd

    def onet_loss(self):
        n = self.batch * PROPOSALS
        onet = seeded(ONet(z_dim=self.widths.get("z_dim", 32),
                           c_dim=self.c_dim, threshold=0.5), self.device)
        args = (self.zeros(n, self.c_dim), self.zeros(n, OCC_POINTS, 3),
                self.zeros(n, OCC_POINTS), self.zeros(n, 8))

        def onet_loss_bwd():
            loss, _ = onet.compute_loss(*args, generator=self.gen)
            return grads_of(loss, onet)
        return onet_loss_bwd


def profile(device, stages=None, iters: int = 8, bf16: bool = False,
            batch: int = BATCH, points: int = POINTS,
            repeats: int = REPEATS, widths: dict | None = None,
            log=print) -> list:
    """Time, count and print each stage in `stages` (None: all); returns
    one row a stage: name, ms, FLOPs (None where not counted), TF/s, the
    shares of the peaks, launches."""
    names = stage_names(batch, points)
    unknown = set(stages or ()) - set(names)
    if unknown:
        raise ValueError(f"profile_train: unknown stages {sorted(unknown)}")
    built = Stages(device, batch, points, bf16, widths)
    rows = []
    for key, name in names.items():
        if stages is not None and key not in stages:
            continue
        fn = built.call(key)
        launches = launches_of(fn, device)  # also the warm-up call
        flops = None if key in NO_FLOPS else count_flops(fn)
        ms = timed_ms(fn, iters, device, repeats)
        tflops = flops / (ms * 1e-3) / 1e12 if flops else None
        row = dict(stage=name, ms=ms, flops=flops, tflops=tflops,
                   pct_f32_peak=(100 * tflops * 1e12 / F32_PEAK
                                 if tflops else None),
                   launches=launches)
        spans = spans_of(fn)
        if spans:
            row["spans"] = spans
        if bf16:
            row["pct_bf16_peak"] = (100 * tflops * 1e12 / BF16_PEAK
                                    if tflops else None)
        rows.append(row)
        log(json.dumps(row))
        del fn
    return rows


def busy_ms(intervals) -> float:
    """The length of the union of (start, end) intervals (us) in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def trace_full_step(device, path: str, bf16: bool = False,
                    batch: int = BATCH, points: int = POINTS,
                    widths: dict | None = None) -> dict:
    """One `full_step` call after a warm-up under `torch.profiler`, its
    Chrome trace written to `path`: the host window, the device-busy
    share and the kernels by device time (the 15 largest)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn = Stages(device, batch, points, bf16, widths).call("full_step")
    fn()
    sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in kernels]) if kernels else None
    return dict(trace=path, window_ms=window, device_busy_ms=busy,
                idle_share=1 - busy / window if kernels else None,
                device_events=len(kernels),
                top=[{"name": n[:120], "ms": ms} for n, ms in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:15]])


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}, nvidia-smi: {nvidia_smi()}", flush=True)
    rows = profile(device, args.stages, args.iters, args.bf16, BATCH, POINTS)
    if args.trace:
        print(json.dumps({"trace_full_step": trace_full_step(
            device, args.trace, args.bf16, BATCH, POINTS)}), flush=True)
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"\nstage breakdown (ms by {clock}, TF/s, % of the 67 TF/s f32 "
          "peak" + (", % of the 989 TF/s bf16 peak" if args.bf16 else "")
          + "):")
    for r in rows:
        line = f"  {r['stage']:18s} {r['ms']:9.2f}"
        if r["tflops"]:
            line += f" {r['tflops']:8.2f} {r['pct_f32_peak']:6.1f}"
            if args.bf16:
                line += f" {r['pct_bf16_peak']:6.2f}"
        print(line)
    return rows


if __name__ == "__main__":
    main()
