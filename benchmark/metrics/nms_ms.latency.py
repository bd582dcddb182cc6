"""The device time of a request's NMS, in ms: the port's span `iscnet.nms`
(the box decode, the empty-box count and the NMS loop on the host with
its copies), which the card spends waiting on the host loop, the median
over the traced segment's requests (`spans.span_ms`). Nothing where the
span did not run."""

from rfdbench.spans import span_ms


def read(ctx):
    return span_ms("iscnet.nms")
