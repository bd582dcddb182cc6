"""The served batches' share of the card's peak over the window: the
FLOPs of one request counted on the plain reference at the cell's shapes
(`FlopCounterMode`: its matrix products), times the requests completed in
the window, over the window and the configuration's peak, in %."""

from rfdbench.readers import mfu_pct as read  # noqa: F401
