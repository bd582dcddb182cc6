"""Served requests through the port's batched serving entry,
`rfdnet_tpu_torch.parallel.serve.make_sharded_generate` (`ISCNet.generate`
to the boxes and the dense grids), in a closed loop: one client, one
request in flight, the next sent when the answer is on the host.

Traffic keys: `batch` (scenes a request), `distinct_batches` (requests
made from the seed and cycled), `num_objects` (box objects a scene),
`check_requests` (answers compared with the reference, drawn from the
seed among those kept), `trace_requests` (requests of a traced segment).
Each request copies its scans to the card and its answer back into host
buffers pinned in set-up (as a server keeps them): the parsed boxes of
every proposal, the slots' ids and valid flags, and the `batch` x
`generate_limit` grids. The answers of the first two cycles of requests
go to buffers of their own and are kept for the check; the rest share
one."""

from __future__ import annotations

import time

import numpy as np
import torch

import rfdref
from rfdbench import compare, scenes, trace, weights
from rfdref import config as refconfig


def generate_kw(cfg: dict) -> dict:
    """`generate`'s keywords from the configuration: its test section's
    NMS settings (`faster_eval: false` keeps the empty-box removal) and
    its generation section's threshold and grid resolution."""
    test, gen = cfg["test"], cfg["generation"]
    return dict(nms_iou=test["nms_iou"], use_cls_nms=test["use_cls_nms"],
                dump_threshold=gen["dump_threshold"],
                remove_empty_box=not test.get("faster_eval", True),
                decode_grid_res=gen["resolution_0"])


def make_inputs(ctx) -> list:
    """The `distinct_batches` requests' point clouds, pinned on the host."""
    tr, cfg = ctx.traffic, ctx.config["config"]
    rng = np.random.RandomState(ctx.seed % 2 ** 32)
    pin = torch.device(ctx.device).type == "cuda"
    out = []
    for _ in range(tr["distinct_batches"]):
        pc = torch.from_numpy(scenes.synthetic_scene_batch(
            rng, batch_size=tr["batch"],
            num_points=cfg["data"]["num_point"],
            num_objects=tr["num_objects"],
            mean_size_arr=refconfig.MEAN_SIZE_ARR)["point_clouds"])
        out.append(pc.pin_memory() if pin else pc)
    return out


class Run:
    """Set-up (inputs, weights, the port's model, warm calls), the
    window, the traced segment, the check."""

    WARM_CALLS = 2

    def __init__(self, ctx):
        from rfdnet_tpu_torch import config as pconfig
        from rfdnet_tpu_torch.parallel.serve import make_sharded_generate

        self.ctx, self.dev = ctx, ctx.device
        cfg, tr = ctx.config, ctx.traffic
        self.mode = cfg["mode"]
        self.kw = generate_kw(cfg["config"])
        self.inputs = make_inputs(ctx)
        self.model = pconfig.build_model(
            pconfig.load_config(cfg["config"], mode=self.mode),
            generate_limit=cfg["generate_limit"], device=self.dev,
            mode=self.mode)
        self.model.load_state_dict(weights.for_run(ctx, self.mode))
        self.serve = make_sharded_generate(self.model, **self.kw)
        res = self.kw["decode_grid_res"]
        ctx.info = {"cbn_points": tr["batch"] * cfg["generate_limit"]
                    * res ** 3}
        self.sent = 0
        self.kept = {}
        # answers kept for the check: those of the first two cycles
        self.keep_below = 2 * tr["distinct_batches"]
        pin = torch.device(self.dev).type == "cuda"
        answer = self.request(0)
        self.ring = compare.host_buffers(answer, pin)
        self.keep_buffers = [compare.host_buffers(answer, pin)
                             for _ in range(self.keep_below)]
        for i in range(1, self.WARM_CALLS):
            self.request(i, self.ring)
        self.sent = 0

    def request(self, i: int, into=None) -> dict:
        """Request i: its scans to the card, `generate`, the answer on the
        host (in `into`, host buffers)."""
        x = self.inputs[i % len(self.inputs)].to(self.dev, non_blocking=True)
        with torch.no_grad():
            out = self.serve({"point_clouds": x})
        self.sent += 1
        return compare.served_to_host(out, into)

    def buffer(self, i: int) -> dict:
        return self.keep_buffers[i] if i < self.keep_below else self.ring

    def window(self, seconds: float) -> dict:
        lat = []
        start = time.perf_counter()
        while True:
            i, t = self.sent, time.perf_counter()
            answer = self.request(i, self.buffer(i))
            done = time.perf_counter()
            lat.append(done - t)
            if i < self.keep_below:
                self.kept[i] = answer
            if done - start >= seconds:
                break
        elapsed = done - start
        n = len(lat)
        ms = np.asarray(lat) * 1e3
        return {"units": n, "window_s": elapsed, "attempted": n,
                "failed": 0, "latencies_ms": ms.tolist(),
                "serve_scenes_per_s": n * self.ctx.traffic["batch"] / elapsed,
                "serve_p95_ms": float(np.percentile(ms, 95)),
                "median_ms": float(np.median(ms))}

    def traced(self):
        return trace.profile_units(
            lambda: self.request(self.sent, self.ring),
            self.ctx.traffic["trace_requests"], self.dev)

    def release(self) -> None:
        self.serve = self.model = None

    def check(self, count_flops: bool = False,
              control: bool = False) -> dict:
        """The reference on a sample of the kept answers' inputs, drawn
        from the seed: the widest gaps over them. With `control`, also the
        reference in TF32 against it (`self.control_readings`)."""
        ctx = self.ctx
        ids = sorted(self.kept)
        rng = np.random.RandomState((ctx.seed + 1) % 2 ** 32)
        n = min(ctx.traffic["check_requests"], len(ids))
        sample = sorted(rng.choice(ids, size=n, replace=False).tolist())
        ref = refconfig.build_model(ctx.config["config"], self.mode,
                                    ctx.config["generate_limit"], self.dev)
        ref.load_state_dict(weights.for_run(ctx, self.mode))

        def answer(x, tf32=False):
            with rfdref.precision(tf32):
                return compare.served_to_host(
                    ref.generate({"point_clouds": x}, **self.kw))

        worst, self.control_readings = {}, {}
        for k, i in enumerate(sample):
            x = self.inputs[i % len(self.inputs)].to(self.dev)
            if count_flops and k == 0:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as counter:
                    expected = answer(x)
                ctx.flops_per_unit = counter.get_total_flops()
            else:
                expected = answer(x)
            _widest(worst, compare.served(self.kept[i], expected))
            if control:
                _widest(self.control_readings,
                        compare.served(answer(x, tf32=True), expected))
        return worst


def _widest(acc: dict, gaps: dict) -> None:
    for name, v in gaps.items():
        acc[name] = max(acc.get(name, 0.0), v)
