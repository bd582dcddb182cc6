"""`BENCHMARK.json` and the files it names, against the benchmark's
contract: names, units, keys, sizes, and that every cell, configuration
and per-layer metric has its files."""

import ast
import json
import math
import re

import pytest

from bench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_paths_hold_the_command_and_nothing_else():
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
        assert (ROOT / p).is_dir()
    files = [w for w in BENCH["command"][1:] if "/" in w or w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in paths)
                         for f in files)


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_have_their_files():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "benchmark" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers"
                / f"{traffic['driver']}.py").is_file()
        limits = json.loads((ROOT / "benchmark" / "limits"
                             / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())


def _metric_keys(m, kind):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
    assert set(m) - {"workloads"} == keys, m["name"]


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        _metric_keys(m, "end_to_end")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


def test_per_layer_metrics_have_readers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        _metric_keys(m, "per_layer")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells
        reach = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(reach)
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or \
                "roofline" in m["name"]:
            assert m["unit"] == "%"
        reader = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        tree = ast.parse(reader.read_text())
        defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        imported = {a.asname or a.name for n in tree.body
                    if isinstance(n, ast.ImportFrom) for a in n.names}
        assert "read" in defined | imported, reader
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", ())
                   for m in BENCH["per_layer"])


def test_bounds_follow_the_rules():
    for m in BENCH["end_to_end"]:
        if m["name"] == "setup_s":
            assert m["bound"] == 0.25
        assert not math.isnan(m["bound"])
