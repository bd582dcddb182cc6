"""The device time of a train step's backward pass, in ms: the port's
span `train.backward` (autograd from the total loss to every parameter's
gradient), the median over the traced segment's steps
(`spans.span_ms`). Nothing where the span did not run."""

from rfdbench.spans import span_ms


def read(ctx):
    return span_ms("train.backward")
