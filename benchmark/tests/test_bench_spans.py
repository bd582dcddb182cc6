"""The readers of the port's spans and counters (`rfdbench/spans.py` and
the metrics that use it) on the CPU at `bench_tiny`'s size: in a traced
run of its cell each returns a number; where its span or counter did not
run in the segment, or where the program keeps no profiled recorder (a
version of the port without spans), it returns nothing."""

import pytest

from bench_tiny import ROOT, run_tiny

from rfdbench import harness

NEW = {"serve_b8": ("grid_decode_ms.serve", "skip_propagation_ms.serve",
                    "valid_slot_pct.serve"),
       "serve_b1": ("nms_ms.latency",),
       "train_b8": ("adam_ms.train", "backward_ms.train")}
# what a cell's traced segment does not run
ABSENT = {"serve_b8": ("adam_ms.train", "backward_ms.train"),
          "serve_b1": ("adam_ms.train", "backward_ms.train"),
          "train_b8": ("grid_decode_ms.serve", "valid_slot_pct.serve",
                       "nms_ms.latency")}


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_span_readers_read_their_cell_and_nothing_else(cell):
    from rfdnet_tpu_torch.utils import profiling

    profiling.profiled().clear()
    out = run_tiny(cell, trace=True)
    for name in NEW[cell]:
        got = out["metrics"][name]
        if got["unit"] == "ms":
            assert got["value"] > 0, out["metrics"]
        else:
            assert 0 <= got["value"] <= 100, out["metrics"]
    for name in ABSENT[cell]:
        assert reader(name).read(None) is None, name
    profiling.profiled().clear()


def test_span_readers_read_nothing_without_the_recorder(monkeypatch):
    from rfdnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "profiled")
    for names in NEW.values():
        for name in names:
            assert reader(name).read(None) is None, name
