"""The port's tracing (`utils/profiling.py`) and `--profile`, on the CPU:
a trace holds the annotated region and the ops inside it, `StageTimer`
accumulates and reports as the JAX package's does, and the demo CLI with
`--profile DIR` writes `DIR/trace.json`.
"""

import json
import os
import time

from rfdnet_tpu.utils import profiling as jprofiling
from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch.utils import profiling
from test_torch_demo import ROOM, SMALL_YAML

import torch


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _events(tmp_path / "t" / "trace.json")}
    assert "my_region" in names
    assert any(n and "mm" in n for n in names)


def test_stage_timer_matches_jax_report():
    ours, theirs = profiling.StageTimer(), jprofiling.StageTimer(sync=False)
    for timer in (ours, theirs):
        for name, ms in (("a", 2), ("b", 1), ("a", 2)):
            with timer.stage(name, result_ref=torch.ones(1)):
                time.sleep(ms / 1e3)
    assert dict(ours.counts) == dict(theirs.counts) == {"a": 2, "b": 1}
    assert ours.totals["a"] >= 4e-3 and ours.totals["b"] >= 1e-3
    lines = ours.report().split("\n")
    assert [ln.split(":")[0] for ln in lines] == ["a", "b"]
    assert lines[0].endswith("(2 calls)") and "ms/call" in lines[0]
    # the same text for the same totals
    theirs.totals.update(ours.totals)
    assert ours.report() == theirs.report()
    ours.reset()
    assert ours.report() == ""


def test_cli_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(SMALL_YAML.format(weight="weights/none"))
    out = cli.main(["--config", str(cfg_path), "--mode", "demo",
                    "--demo_path", ROOM, "--device", "cpu",
                    "--profile", str(tmp_path / "prof")])
    assert os.path.exists(tmp_path / out / "pred.png")
    names = {e.get("name") for e in _events(tmp_path / "prof" /
                                            "trace.json")}
    # the demo's ops ran inside the trace
    assert any(n and n.startswith("aten::") for n in names)
    assert len(names) > 20
