"""Tracing and stage timing.

Counterpart of `rfdnet_tpu/utils/profiling.py`: `trace(log_dir)` wraps a
region in a `torch.profiler` trace (CPU activity, and CUDA activity where
a card is present) written as a Chrome trace (`trace.json`, readable in
Perfetto or chrome://tracing) under `log_dir`; `annotate(name)` names a
sub-region on that trace's timeline; `StageTimer` collects named
host-clock stages, waiting for the card at each stage's end
(`torch.cuda.synchronize`, where the JAX package reads a result back).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region; its Chrome trace lands in
    `<log_dir>/trace.json` when the region ends (also on an exception)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named sub-region of the trace (`torch.profiler.record_function`)."""
    return record_function(name)


class StageTimer:
    """Accumulating host-clock stage timer.

    with timer.stage("backbone", result): ...
    print(timer.report())

    With `sync` and a result given, a stage waits for the card (all
    streams of the current device) before its clock stops."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self, x=None):
        if self.sync and x is not None and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str, result_ref=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync(result_ref)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / n * 1e3:.1f} ms/call "
                         f"({n} calls)")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
