"""The card's idle share while it serves the window's served batches: 1 -
(union of device operation intervals a unit over the traced segment) /
(the untraced window's time a unit), in % (`readers.idle_pct`)."""

from rfdbench.readers import idle_pct as read  # noqa: F401
