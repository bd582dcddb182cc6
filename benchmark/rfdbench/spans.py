"""Readers of the port's own spans and counters
(`rfdnet_tpu_torch.utils.profiling`): what the program recorded while the
traced segment ran under `torch.profiler`, which its process-wide
recorder `profiling.profiled()` keeps (the segment is the only profiled
part of a run). A span reading is the median over the segment's calls of
that span, so that the one unit traced with the host's ops too does not
weigh. Every reading is None where the program keeps no such recorder
(a version of the port without spans), or where the span or counter did
not run."""

from __future__ import annotations

import statistics


def table():
    """The profiled recorder's table, or None without one."""
    try:
        from rfdnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    profiled = getattr(profiling, "profiled", None)
    return None if profiled is None else profiled().table()


def span_ms(name: str):
    """The median over the segment's calls of span `name` of its device
    ms (its host ms where it has no device time: on the CPU)."""
    t = table()
    row = t["spans"].get(name) if t else None
    if not row:
        return None
    return statistics.median(row["device_samples"] or row["host_samples"])


def counter(name: str):
    """A counter's sum over the segment, or None where it never counted."""
    t = table()
    return t["counters"].get(name) if t else None
