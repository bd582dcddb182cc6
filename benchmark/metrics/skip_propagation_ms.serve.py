"""The device time of a served batch's skip propagation, in ms: the
port's span `iscnet.skip_propagation` (the top-`generate_limit` selection,
the proposals' gathers and the skip-propagation network to the
conditioning codes), the median over the traced segment's batches
(`spans.span_ms`). Nothing where the span did not run."""

from rfdbench.spans import span_ms


def read(ctx):
    return span_ms("iscnet.skip_propagation")
