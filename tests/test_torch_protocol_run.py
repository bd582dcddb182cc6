"""`rfdnet_tpu_torch.tools.protocol_run` against the JAX tool
`tools/protocol_run.py`, on the CPU: the schedule evidence of the same run
directories (`tests/test_protocol_run.py`'s stitched, resumed stage among
them), the stage and test configs of `main`, `_run_train`'s chunk
targets, skip of passed chunks and retry budget (with `subprocess.run`
replaced by a recorder), a chain whose predecessor wrote no weights, and
one run of `main` over the three stages and the test at a small size, its
training chunks routed to an in-process `cli.main`, in which stage 2,
stage 3 and the test each load their predecessor's weights.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.tools import gen_synthetic_dataset as gen
from rfdnet_tpu_torch.tools import protocol_run as pr
from tools import protocol_run as jax_tool

STAGES = ("stage1_detection", "stage2_completion", "stage3_joint")
FROZEN = ("backbone", "voting", "detection")


def _write_run(stage_dir, name, epochs, lr, log_lines=()):
    run = os.path.join(stage_dir, name)
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "scalars.jsonl"), "w") as f:
        for e in epochs:
            f.write(json.dumps({
                "phase": "schedule", "epoch": e, "lr": lr,
                "bn_momentum": 0.5 * 0.5 ** (e / 20), "val_total": 100.0 - e,
            }) + "\n")
            f.write(json.dumps({"phase": "train", "epoch": e,
                                "total": 1.0}) + "\n")
    if log_lines is not None:
        with open(os.path.join(run, "log.txt"), "w") as f:
            f.write("\n".join(log_lines) + "\n")
    return run


def _stitched(stage):
    # tests/test_protocol_run.py's resumed stage: epochs 0..32 at 1e-4,
    # then 30..59 (30-32 repeated) at a reduced lr, and a stray file
    _write_run(stage, "2026-01-01T00:00:00", range(0, 33), 1e-4,
               ["epoch 30: new best val loss 70.0"])
    _write_run(stage, "2026-01-01T02:00:00", range(30, 60), 1e-5,
               ["epoch 41: plateau patience exceeded, LR 1e-4 -> 1e-5",
                "epoch 55: new best val loss 45.0"])
    with open(os.path.join(stage, "completion_0.0001.yaml"), "w") as f:
        f.write("{}")


def _single(stage):
    _write_run(stage, "2026-01-01T00:00:00", range(0, 10), 1e-3,
               ["epoch 3: new best val loss 97.0"])


def _crashed(stage):
    # a run without a log, and a newer one that died before writing
    _write_run(stage, "2026-01-01T00:00:00", range(0, 4), 1e-3, None)
    os.makedirs(os.path.join(stage, "2026-01-01T01:00:00"))


@pytest.mark.parametrize("runs", [_stitched, _single, _crashed],
                         ids=lambda f: f.__name__.strip("_"))
def test_schedule_evidence_matches_jax_tool(tmp_path, runs):
    stage = str(tmp_path / "stage")
    os.makedirs(stage)
    runs(stage)
    got = pr._schedule_evidence(stage)
    assert got == jax_tool._schedule_evidence(stage)
    if runs is _stitched:
        assert [r["epoch"] for r in got["schedule"]] == list(range(60))
        assert got["schedule"][31]["lr"] == 1e-5  # the newest run wins
        assert got["schedule"][29]["lr"] == 1e-4
        assert got["lr_reductions"] == [
            {"epoch": 41, "from": 1e-4, "to": 1e-5}]
        assert got["last_best"] == {"epoch": 55, "val_total": 45.0}


# ------------------------------------------------ configs of `main`

ARGV = ["--epochs", "7", "5", "3", "--batch", "4", "--chunk", "2",
        "--seed", "3", "--save-step", "2", "--stage3-threshold", "0.05"]
CONFIGS = ("stage1_detection/detection_0.001.yaml",
           "stage2_completion/completion_0.0001.yaml",
           "stage3_joint/completion_5e-05.yaml", "test.yaml")


def _fake_runs(out: str, weights=STAGES) -> None:
    """A run directory a stage, holding `model_best` and `model_last`
    for the stages in `weights`."""
    for stage in STAGES:
        run = os.path.join(out, stage, "2026-01-01T00:00:00.000000")
        os.makedirs(run, exist_ok=True)
        if stage in weights:
            for name in ("model_best", "model_last"):
                np.savez(os.path.join(run, name + ".npz"))


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Both tools' `main` on one dataset root and output directory, with
    `_run_train` and the CLI's test mode replaced by recorders: the
    configs each wrote (read by PyYAML, and the port's also by
    `config.parse_yaml`) and the calls each made."""
    import rfdnet_tpu.cli as jax_cli

    tmp = tmp_path_factory.mktemp("mains")
    root, out = str(tmp / "ds"), str(tmp / "out")
    os.makedirs(os.path.join(root, "splits"))
    with open(os.path.join(root, "splits", "scannetv2_train.json"), "w") as f:
        f.write("[]")
    _fake_runs(out)
    calls = {"jax": [], "port": []}
    configs = {}

    def recorder(key):
        def run_train(yaml_path, total_epochs, chunk, retries=3, **kw):
            calls[key].append(("train", os.path.relpath(yaml_path, out),
                               total_epochs, chunk, retries, kw))
            return []
        return run_train

    def test_mode(key):
        def main(argv):
            calls[key].append(("test", argv))
            return {"mAP @0.25": 0.5}
        return main

    def read(texts: dict) -> dict:
        return {name: yaml.safe_load(text) for name, text in texts.items()}

    def written() -> dict:
        texts = {}
        for name in CONFIGS:
            with open(os.path.join(out, name)) as f:
                texts[name] = f.read()
            os.remove(os.path.join(out, name))
        return texts

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tool, "_run_train", recorder("jax"))
        mp.setattr(jax_cli, "main", test_mode("jax"))
        mp.setattr(pr, "_run_train", recorder("port"))
        mp.setattr(cli, "main", test_mode("port"))
        jax_results = jax_tool.main(["--root", root, "--out", out, *ARGV])
        configs["jax"] = read(written())
        port_results = pr.main(["--root", root, "--out", out, *ARGV,
                                "--device", "cpu"])
        texts = written()
        configs["port"] = read(texts)
        configs["port_parsed"] = {name: tconfig.parse_yaml(text)
                                  for name, text in texts.items()}
    return dict(out=out, calls=calls, configs=configs,
                results={"jax": jax_results, "port": port_results})


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_match_jax_tool(mains, name):
    want = mains["configs"]["jax"][name]
    assert mains["configs"]["port"][name] == want
    assert mains["configs"]["port_parsed"][name] == want


def test_stage_calls_match_jax_tool(mains):
    """The same stages, epochs and chunks; `--device` passed to every
    chunk and to the test mode."""
    jax_calls, port_calls = mains["calls"]["jax"], mains["calls"]["port"]
    assert len(port_calls) == len(jax_calls) == 4
    for got, want in zip(port_calls[:3], jax_calls[:3]):
        assert got[:5] == want[:5] and want[5] == {}
        assert got[5] == {"device": "cpu"}
    assert port_calls[3] == ("test", [*jax_calls[3][1], "--device", "cpu"])
    out, results = mains["out"], mains["results"]
    # the weights each stage and the test start from
    runs = {s: os.path.join(out, s, "2026-01-01T00:00:00.000000")
            for s in STAGES}
    assert results["port"]["weights"] == {
        "completion": os.path.join(runs["stage1_detection"], "model_best"),
        "joint": os.path.join(runs["stage2_completion"], "model_last"),
        "test": os.path.join(runs["stage3_joint"], "model_best")}
    assert set(results["jax"]) <= set(results["port"])
    assert results["port"]["stages"] == results["jax"]["stages"]


@pytest.mark.parametrize("missing", STAGES)
def test_a_stage_without_its_predecessors_weights_raises(tmp_path,
                                                         monkeypatch,
                                                         missing):
    """Where a stage's predecessor wrote no weight file, `main` raises
    before that stage (the CLI would train it from the seeded init)."""
    root, out = str(tmp_path / "ds"), str(tmp_path / "out")
    os.makedirs(os.path.join(root, "splits"))
    with open(os.path.join(root, "splits", "scannetv2_train.json"), "w") as f:
        f.write("[]")
    _fake_runs(out, weights=[s for s in STAGES if s != missing])
    ran = []
    monkeypatch.setattr(pr, "_run_train", lambda y, *a, **kw: ran.append(
        os.path.basename(os.path.dirname(y))) or [])
    monkeypatch.setattr(cli, "main", lambda argv: ran.append("test") or {})
    with pytest.raises(FileNotFoundError, match=missing):
        pr.main(["--root", root, "--out", out, "--device", "cpu"])
    assert ran == list(STAGES[:STAGES.index(missing) + 1])


def test_predecessor_is_the_newest_run_holding_the_file(tmp_path):
    """A resumed stage whose last chunk found no better val loss: its
    newest run directory holds `model_last` only, so the stage's best is
    the `model_best` of the run before (the JAX tool would point the next
    stage at the newest run's, which is missing)."""
    stage = str(tmp_path / "stage1_detection")
    old, new = (os.path.join(stage, f"2026-01-01T0{h}:00:00") for h in (0, 1))
    for run, names in ((old, ("model_best", "model_last")),
                       (new, ("model_last",))):
        os.makedirs(run)
        for name in names:
            np.savez(os.path.join(run, name + ".npz"))
    os.makedirs(os.path.join(stage, "2026-01-01T02:00:00"))  # died at start
    assert pr.predecessor(stage, "model_best") == os.path.join(
        old, "model_best")
    assert pr.predecessor(stage, "model_last") == os.path.join(
        new, "model_last")
    assert not os.path.isfile(os.path.join(
        jax_tool._run_dir(stage), "model_best.npz"))


# ------------------------------------------------------- `_run_train`


def _stage(tool, out: str) -> str:
    return tool._stage_yaml("/data/splits", "/data/shapenet", out,
                            phase="completion", lr=1e-4, epochs=10, batch=4,
                            weight=("/w/model_best",))


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("case,fails,raises", [
    ("fresh", 0, False), ("resumed", 0, False),
    ("retries_last", 3, False), ("retries_out", 4, True)])
def test_run_train_matches_jax_tool(tmp_path, monkeypatch, device, case,
                                    fails, raises):
    """Chunk targets 4, 8, 10 of a 10-epoch stage at `--chunk 4`; resumed
    past epoch 4 by the newest run directory whose log names a finished
    epoch (a newer one that died before any is passed over), only 8 and
    10; the stage's three retries, and a fourth failure raising. Each
    chunk's argv and the epoch target its config holds when it starts."""
    def run(tool, out):
        yaml_path = _stage(tool, out)
        if case == "resumed":
            _write_run(out, "2026-01-01T00:00:00", range(0, 2), 1e-4,
                       ["train epoch 1 done in 1.0s"])
            _write_run(out, "2026-01-01T01:00:00", range(2, 5), 1e-4,
                       [f"train epoch {e} done in 1.0s" for e in (2, 3, 4)])
            _write_run(out, "2026-01-01T02:00:00", [], 1e-4, [])
        seen = []

        def record(argv, **kw):
            with open(yaml_path) as f:
                epochs = yaml.safe_load(f)["train"]["epochs"]
            seen.append((argv, epochs))
            return subprocess.CompletedProcess(argv, int(len(seen) <= fails))

        monkeypatch.setattr(subprocess, "run", record)
        kw = {} if tool is jax_tool else {"device": device}
        try:
            chunks = tool._run_train(yaml_path, 10, 4, **kw)
        except RuntimeError as e:
            chunks = e
        monkeypatch.undo()
        return yaml_path, seen, chunks

    jax_yaml, jax_seen, jax_chunks = run(jax_tool, str(tmp_path / "jax"))
    port_yaml, port_seen, chunks = run(pr, str(tmp_path / "port"))
    targets = [4, 8, 10] if case != "resumed" else [8, 10]
    if raises:
        assert isinstance(jax_chunks, RuntimeError)
        assert isinstance(chunks, RuntimeError)
        assert str(chunks) == str(jax_chunks)
    else:
        assert [c["epochs"] for c in chunks] == targets
        assert [c["tries"] for c in chunks] == [fails + 1] + [1] * (
            len(targets) - 1)
    assert len(port_seen) == len(jax_seen) == (
        fails + len(targets) if not raises else fails)
    for (argv, epochs), (jax_argv, jax_epochs) in zip(port_seen, jax_seen):
        assert epochs == jax_epochs
        assert jax_argv == [sys.executable, "-m", "rfdnet_tpu", "--config",
                            jax_yaml, "--mode", "train"]
        assert argv == [sys.executable, "-m", "rfdnet_tpu_torch", "--config",
                        port_yaml, "--mode", "train",
                        *(["--device", device] if device else [])]
    assert [e for _, e in port_seen] == (
        [4] * (fails + 1) + [8, 10] if case != "resumed" else [8, 10]
    )[:len(port_seen)]


# ------------------------------------------------ the chain on the CPU

SMALL = {"num_target": 32, "c_dim": 64, "hidden_dim": 64, "z_dim": 8,
         "completion_limit_in_train": 4}


def test_main_on_cpu_loads_each_predecessor(tmp_path, monkeypatch, capsys):
    """The generator's scenes (2 train, 1 val), then `main --epochs 1 1 1
    --batch 2 --chunk 1 --device cpu` at 2048 points and narrow widths,
    each chunk's `python -m rfdnet_tpu_torch` run by `cli.main` in this
    process: every stage's run directory has its epoch and schedule row;
    stage 2 and stage 3 finetune from their predecessor's file and the
    test loads stage 3's best, with no weight path missing; stage 2 leaves
    the frozen modules' parameters as stage 1 saved them; metrics.json
    holds the box and mesh mAP."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    build = tconfig.build_model

    def small_model(cfg, generate_limit=64, device=None, mode=None):
        cfg = copy.deepcopy(cfg)
        cfg["data"].update(SMALL)
        return build(cfg, generate_limit=8, device=device, mode=mode)

    monkeypatch.setattr(cli, "build_model", small_model)
    monkeypatch.setattr(pr, "N_POINTS", 2048)
    real_run = subprocess.run

    def run(argv, env=None, **kw):
        if argv[1:3] != ["-m", "rfdnet_tpu_torch"]:
            return real_run(argv, env=env, **kw)
        assert env["PYTHONPATH"].split(os.pathsep)[0] == pr.PACKAGE_PARENT
        cli.main(argv[3:])
        return subprocess.CompletedProcess(argv, 0)

    monkeypatch.setattr(subprocess, "run", run)
    root, out = str(tmp_path / "ds"), str(tmp_path / "out")
    gen.main(["--out", root, "--train", "2", "--val", "1", "--points",
              "5000", "--variants", "1"])
    results = pr.main(["--root", root, "--out", out, "--epochs", "1", "1",
                       "1", "--batch", "2", "--chunk", "1", "--device",
                       "cpu"])
    printed = capsys.readouterr().out

    logs = {}
    for stage in STAGES:
        run_dir = pr._run_dir(os.path.join(out, stage))
        with open(os.path.join(run_dir, "log.txt")) as f:
            logs[stage] = f.read()
        assert "train epoch 0 done" in logs[stage], stage
    for key in ("detection", "completion", "joint"):
        assert [r["epoch"] for r in results["stages"][key]["schedule"]] == [0]
        assert [c["epochs"] for c in results["chunks"][key]] == [1]
        assert [len(v) for v in results["epoch_s"][key].values()] == [1, 1]
    w = results["weights"]
    assert w["completion"] == os.path.join(
        pr._run_dir(os.path.join(out, "stage1_detection")), "model_best")
    assert w["joint"] == os.path.join(
        pr._run_dir(os.path.join(out, "stage2_completion")), "model_last")
    assert w["test"] == os.path.join(
        pr._run_dir(os.path.join(out, "stage3_joint")), "model_best")
    assert f"finetuned from {w['completion']}.npz" in logs[
        "stage2_completion"]
    assert f"finetuned from {w['joint']}.npz" in logs["stage3_joint"]
    assert f"loaded weights {w['test']}.npz" in printed
    assert "not found" not in printed + "".join(logs.values())

    with np.load(w["completion"] + ".npz") as a, \
            np.load(w["joint"] + ".npz") as b:
        frozen = [k for k in a.files if k.startswith("params/")
                  and k.split("/")[1] in FROZEN]
        assert frozen
        for k in frozen:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    with open(os.path.join(out, "metrics.json")) as f:
        saved = json.load(f)
    metrics = saved["metrics"]
    for k in ("mAP @0.25", "mAP @0.5", "mAP_mesh @0.25", "AR_mesh @0.5"):
        assert np.isfinite(metrics[k]), k
    classes = set(tconfig.CLASS2TYPE.values())
    assert {k.removesuffix(" voxel IoU") for k in metrics
            if k.endswith(" voxel IoU")} <= classes
    assert saved["config"]["epochs"] == [1, 1, 1]
