"""The device time of a served batch's dense grid decode, in ms: the
port's span `iscnet.grid_decode` (the CBN decoder's launch with its set-up:
the folded tables, the grid points, z), the median over the traced
segment's batches (`spans.span_ms`). Nothing where the span did not run."""

from rfdbench.spans import span_ms


def read(ctx):
    return span_ms("iscnet.grid_decode")
