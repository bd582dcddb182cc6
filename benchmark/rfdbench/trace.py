"""The traced segment of a `--trace 1` run: a bounded number of the
cell's units (batches, steps, requests) under `torch.profiler` after the
measured window, read into kernel intervals, the device's busy time, the
kernels that took most time and the longest idle gaps by what the host
was doing. Nothing is written to disk."""

from __future__ import annotations

import time

import torch

from .arith import busy_s


class Segment:
    """What a traced segment read: `kernels` [(name, start_s, end_s)] of
    the device over `units` units, `window_s` (host clock over the
    segment), `busy_s`; and, from one more unit traced with the host's ops
    too, `gap_kernels` and `host_ops` [(name, start_s, end_s)] for the
    idle gaps."""

    def __init__(self, kernels, units: int, window_s: float, gap_kernels=(),
                 host_ops=()):
        self.kernels = kernels
        self.units = units
        self.window_s = window_s
        self.gap_kernels = list(gap_kernels)
        self.host_ops = list(host_ops)
        self.busy_s = busy_s([(s, e) for _, s, e in kernels])

    def kernel_time(self, *names: str):
        """(launches, seconds) of the kernels whose name holds any of
        `names`."""
        picked = [e - s for n, s, e in self.kernels
                  if any(part in n for part in names)]
        return len(picked), sum(picked)

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:160], t] for n, t in sorted(
            by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle gaps between device operations, each named by the
        innermost host op that spans its middle (the one that started
        last), summed by name: the largest `top`."""
        import bisect

        spans = sorted((s, e) for _, s, e in self.gap_kernels)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in host]
        by = {}
        for a, b in gaps:
            mid = (a + b) / 2
            name = "host"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4096, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n[:160], t] for n, t in sorted(
            by.items(), key=lambda kv: -kv[1])[:top]]


def _events(prof):
    """The profiler's raw events: (device operations, host ops), each
    [(name, start_s, end_s)]."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), *span))
        else:
            host.append((e.name(), *span))
    return device, host


def profile_units(unit, count: int, device, warm: int = 1) -> Segment:
    """Run `unit()` `warm` times, then `count` times under the profiler
    with the device's activity alone (the host's op records would slow
    the host and widen the idle gaps they are to explain), then once more
    with the host's ops too, for naming the idle gaps. On the CPU, host
    ops alone."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warm):
        unit()
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            unit()
        sync()
        window = time.perf_counter() - t0
    kernels, _ = _events(prof)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        unit()
        sync()
    gap_kernels, host = _events(prof)
    return Segment(kernels, count, window, gap_kernels, host)
