"""The yardstick's arithmetic: the card's peaks, a kernel's least time
from its operations and bytes, and the union of busy intervals.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67
TFLOP/s in float32 outside the tensor cores (what the f32 configurations
run: TF32 stays off), 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s
of HBM. A configuration file names the peak its precision runs at
(`peak_flops_per_s`). Operations and bytes are those the algorithm needs
for the call, from its shapes: each input byte read once, each output
byte written once."""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak_flops: float,
            peak_bytes: float = HBM_BYTES_PER_S) -> float:
    """The least time of a call: the larger of operations over the peak
    rate and bytes over the memory bandwidth."""
    return max(nbytes / peak_bytes, flops / peak_flops)


def cbn_decode_work(points: int, hidden: int = 256, layers: int = 10):
    """(bytes, flops) of one f32 CBN decode of `points` grid points over
    all its proposals: h0 read (hidden floats a point) and the logit
    written; ten hidden x hidden products a point."""
    nbytes = points * hidden * 4 + points * 4
    return nbytes, 2.0 * points * layers * hidden ** 2


def fps_work(b: int, n: int, npoint: int):
    """(bytes, flops) of one FPS call, b clouds of n points to npoint
    samples: the cloud read and the indices written; per step and point
    3 subtractions, 3 products, 2 adds, a min and a compare."""
    return b * (n * 12 + npoint * 4), 10.0 * b * n * (npoint - 1)


def busy_s(intervals) -> float:
    """The length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
