"""`rfdnet_tpu_torch.tools.profile_train` on the CPU: its stage names and
`--stages` filter are the JAX tool's (`tools/profile_train.py`, read as
source), every stage runs at batch 1 x 2048 points, the FLOP counter's
count of `backbone_fwd` equals a sum by hand, and `main` prints its table.
"""

import ast
import os

import pytest
import torch

from rfdnet_tpu_torch.tools import profile_train as pt
from torch_parity import ROOT, SANITY_WIDTHS

CPU = torch.device("cpu")
B, N = 1, 2048


def _jax_tool_stages():
    """The JAX tool's `want(...)` keys and `report(...)` names, in order."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "profile_train.py"))
                     .read())
    keys, names = [], []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.args and isinstance(node.args[0], ast.Constant)):
            if node.func.id == "want":
                keys.append((node.lineno, node.args[0].value))
            elif node.func.id == "report":
                names.append((node.lineno, node.args[0].value))
    return [k for _, k in sorted(keys)], [n for _, n in sorted(names)]


def test_stage_names_and_filter_match_jax_tool():
    keys, names = _jax_tool_stages()
    got = pt.stage_names()  # at the JAX tool's batch 8 x 80000
    assert list(got) == keys
    assert list(got.values()) == names
    args = pt.parse_args(["--stages", "fps_sa1", "onet_loss", "--iters", "2",
                          "--bf16"])
    assert args.stages == ["fps_sa1", "onet_loss"] and args.iters == 2
    assert args.bf16 and pt.parse_args([]).stages is None
    assert pt.parse_args([]).iters == 8
    with pytest.raises(ValueError, match="unknown stages"):
        pt.profile(CPU, ["sa1_fwd"], batch=B, points=N)


def test_every_stage_runs_on_cpu():
    rows = pt.profile(CPU, None, iters=1, batch=B, points=N, repeats=1,
                      widths=SANITY_WIDTHS, log=lambda _: None)
    assert [r["stage"] for r in rows] == list(pt.stage_names(B, N).values())
    for key, r in zip(pt.stage_names(B, N), rows):
        assert r["ms"] > 0, r
        assert r["launches"] == {"fps": 0, "cbn_decode": 0,
                                 "adam": 0}  # plain on CPU
        if key in pt.NO_FLOPS:
            assert r["flops"] is None and r["tflops"] is None
        else:
            assert r["flops"] > 0 and r["tflops"] > 0, r
            assert r["pct_f32_peak"] == pytest.approx(
                100 * r["tflops"] * 1e12 / pt.F32_PEAK)
    # the filter keeps the named stages only
    rows = pt.profile(CPU, ["ballq_sa1"], iters=1, batch=B, points=N,
                      repeats=1, log=lambda _: None)
    assert [r["stage"] for r in rows] == ["ballq_sa1"]


def test_backbone_flops_equal_hand_sum():
    """2 x rows x in x out over every SharedMLP layer of the backbone (rows:
    B x npoint x nsample in an SA layer, B x points in an FP layer), plus
    the distance products that ball query (|c|^2 + |p|^2 - 2 c.p) and
    three-NN make with k = 3: 2 x B x centres x points x 3."""
    stages = pt.Stages(CPU, B, N)
    bb = pt.Pointnet2Backbone(input_feature_dim=1)
    want, n = 0, N
    for sa in (bb.sa1, bb.sa2, bb.sa3, bb.sa4):
        rows = B * sa.npoint * sa.nsample
        for i in range(sa.mlp.n):
            d = getattr(sa.mlp, f"dense{i}")
            want += 2 * rows * d.in_features * d.out_features
        want += 2 * B * sa.npoint * n * 3
        n = sa.npoint
    for fp, unknown, known in ((bb.fp1, bb.sa3.npoint, bb.sa4.npoint),
                               (bb.fp2, bb.sa2.npoint, bb.sa3.npoint)):
        for i in range(fp.mlp.n):
            d = getattr(fp.mlp, f"dense{i}")
            want += 2 * B * unknown * d.in_features * d.out_features
        want += 2 * B * unknown * known * 3
    assert pt.count_flops(stages.call("backbone_fwd")) == want


def test_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(pt, "BATCH", B)
    monkeypatch.setattr(pt, "POINTS", N)
    rows = pt.main(["--device", "cpu", "--iters", "1", "--stages",
                    "fps_sa1", "ballq_sa1"])
    out = capsys.readouterr().out
    assert [r["stage"] for r in rows] == ["fps_sa1(1x2k)", "ballq_sa1"]
    assert "stage breakdown (ms by host clock" in out
    assert "fps_sa1(1x2k)" in out.splitlines()[-2]
