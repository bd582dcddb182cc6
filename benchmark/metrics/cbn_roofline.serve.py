"""The f32 CBN decode kernel's share of its roofline in the traced
segment: its least time from the decode's operations and bytes at the
configuration's peak (`arith.cbn_decode_work`, the grid points of a
request's `batch` x `generate_limit` proposals), times its launches, over
its device time, in %. Selected by kernel name; nothing when the kernel
did not run."""

from rfdbench.arith import bound_s, cbn_decode_work

KERNELS = ("cbn_decode_kernel",)


def read(ctx):
    seg = ctx.segment
    launches, seconds = seg.kernel_time(*KERNELS)
    if not launches:
        return None
    nbytes, flops = cbn_decode_work(ctx.info["cbn_points"])
    bound = bound_s(nbytes, flops, ctx.config["peak_flops_per_s"])
    return 100.0 * launches * bound / seconds
