"""The median latency of the window's requests (host clock, from the
scans leaving the host to the answer back on it), in ms: the same
requests as `serve_p95_ms`, a steadier statistic beside the tail."""


def read(ctx):
    return ctx.window["median_ms"]
