"""The useful share of the grids decoded in the traced segment, in %: the
port's counters `iscnet.slots_valid` (the slots above the dump threshold
after NMS) over `iscnet.slots_decoded` (every slot of every scene, B x
`generate_limit`), summed over the segment. Nothing where no grid was
decoded."""

from rfdbench.spans import counter


def read(ctx):
    decoded = counter("iscnet.slots_decoded")
    if not decoded:
        return None
    return 100.0 * counter("iscnet.slots_valid") / decoded
