"""The FPS kernel's share of its roofline in the traced train steps: the
least time of a step's five FPS calls (SA1-SA4 and the proposals'
seed_fps, `arith.fps_work` from their shapes at the configuration's
peak), times the steps traced, over the FPS kernels' device time, in %.
Selected by kernel name; nothing when no FPS kernel ran."""

from rfdbench.arith import bound_s, fps_work

KERNELS = ("fps_resident", "fps_streaming")


def read(ctx):
    seg = ctx.segment
    launches, seconds = seg.kernel_time(*KERNELS)
    if not launches:
        return None
    b, peak = ctx.traffic["batch"], ctx.config["peak_flops_per_s"]
    step = sum(bound_s(*fps_work(b, n, k), peak)
               for n, k in ctx.info["fps_calls"])
    return 100.0 * (launches / len(ctx.info["fps_calls"])) * step / seconds
