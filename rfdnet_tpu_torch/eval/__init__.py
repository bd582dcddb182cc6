"""Host-side evaluation helpers (numpy): box utilities, and the box and
mesh placement the demo dump uses."""
