"""The plain reference against the port's CPU path at a tiny size, through
the rest of a run (the card's look skipped): each cell's compared
numbers come out 0 and `correct` true, and a traced run reports the
cell's per-layer metrics that a CPU run can read."""

import pytest

from bench_tiny import run_tiny

CELLS = ["serve_b8", "serve_b1", "train_b8"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    out = run_tiny(name)
    assert out["correct"] is True
    assert all(c["value"] == 0.0 for c in out["compared"].values()), out
    assert list(out)[-1] == "compared"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("name,metric", [("serve_b8", "mfu.serve"),
                                         ("train_b8", "mfu.train"),
                                         ("serve_b1", "median_ms.latency")])
def test_traced_run_reports_host_side_metrics(name, metric):
    out = run_tiny(name, trace=True)
    assert out["correct"] is True
    assert metric in out["metrics"]
    assert 0 < out["metrics"][metric]["value"]
    assert "breakdown" in out and "busy_s" in out["device"]
