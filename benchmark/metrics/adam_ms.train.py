"""The device time of a train step's optimizer update, in ms: the port's
span `train.adam` (`train.trainer.Adam.step` over every parameter, the
gradients' all-reduce left out), the median over the traced segment's
steps (`spans.span_ms`). Nothing where the span did not run."""

from rfdbench.spans import span_ms


def read(ctx):
    return span_ms("train.adam")
