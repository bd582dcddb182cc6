"""What the benchmark may import: nothing under `benchmark/` loads JAX or
the JAX package (top-level module names compared whole, so the port
`rfdnet_tpu_torch` is not `rfdnet_tpu`), and the plain reference
(`benchmark/rfdref/`) imports nothing of the port."""

import ast

import pytest

from bench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rfdnet_tpu"}
FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_names():
    assert "rfdnet_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES
                                  if "rfdref" in p.parts], ids=lambda p: str(
    p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "rfdnet_tpu_torch" not in names
    assert names <= {"__future__", "torch", "numpy", "math", "contextlib",
                     "dataclasses", "typing"}, names


def test_the_harness_reads_no_old_benchmark():
    text = "\n".join(p.read_text() for p in FILES if "tests" not in p.parts)
    for old in ("bench.py", "bench_ops", "BENCH_r", "MULTICHIP_",
                "BASELINE.json", "chip_smoke"):
        assert old not in text
