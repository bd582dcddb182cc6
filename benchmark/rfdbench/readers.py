"""Readers shared by per-layer metrics of the same kind in several cells
(each metric's file under `benchmark/metrics/` names one)."""

from __future__ import annotations


def idle_pct(ctx):
    """1 - (device busy time a unit in the traced segment) / (time a unit
    in the untraced window), in %. The profiler's launch callbacks make a
    traced unit longer than an untraced one (a train step 443 ms against
    390), so the traced segment's own length would count them as idle."""
    seg = ctx.segment
    if seg is None or not seg.kernels:
        return None
    w = ctx.window
    unit_s = w["window_s"] / w["units"]
    return 100.0 * (1.0 - seg.busy_s / seg.units / unit_s)


def mfu_pct(ctx):
    """FLOPs of a unit (counted on the reference) x units in the window /
    window / peak, in %."""
    if not ctx.flops_per_unit:
        return None
    w = ctx.window
    return (100.0 * ctx.flops_per_unit * w["units"] / w["window_s"]
            / ctx.config["peak_flops_per_s"])
