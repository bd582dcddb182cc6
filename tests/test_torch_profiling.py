"""The port's tracing (`utils/profiling.py`) and `--profile`, on the CPU:
a trace holds a span's region and the ops inside it, and the demo CLI
with `--profile DIR` writes `DIR/trace.json` (the spans themselves:
`tests/test_torch_spans.py`).
"""

import json
import os

from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch.utils import profiling
from test_torch_demo import ROOM, SMALL_YAML

import torch


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _events(tmp_path / "t" / "trace.json")}
    assert "my_region" in names
    assert any(n and "mm" in n for n in names)


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
