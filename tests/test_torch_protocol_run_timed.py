"""`rfdnet_tpu_torch.tools.protocol_run_timed` on the CPU: the estimate and
the cut of the epochs from a probe's times, and `main` with the generator
and `protocol_run.main` replaced by recorders: the probe and the run it
asks for, the files it deletes (only its own), and what `--keep` gets.
"""

import json
import os

import pytest

from rfdnet_tpu_torch.tools import gen_synthetic_dataset as gen
from rfdnet_tpu_torch.tools import protocol_run as pr
from rfdnet_tpu_torch.tools import protocol_run_timed as timed

KEYS = ("detection", "completion", "joint")


def _probe_results(test_s=90.0):
    """`protocol_run.main`'s results at two epochs a stage, one chunk."""
    return {
        "chunks": {k: [{"epochs": 2, "seconds": s, "tries": 1}]
                   for k, s in zip(KEYS, (35.0, 40.0, 39.0))},
        "epoch_s": {k: {"train": [14.0, t], "val": [1.0, 1.0]}
                    for k, t in zip(KEYS, (8.0, 10.0, 12.0))},
        "test_s": test_s,
    }


def test_estimate_from_the_probe():
    stages = timed.probe_times(_probe_results())
    assert stages["completion"] == {"chunk_s": 40.0, "train_s": [14.0, 10.0],
                                    "val_s": [1.0, 1.0]}
    # steady epochs 9 / 11 / 13 s; start-up 35 - 18, 40 - 22, 39 - 26 s
    want = 90.0 + (100 * 9 + 3 * 17) + (60 * 11 + 2 * 18) + (40 * 13 + 13)
    assert timed.estimate_s([100, 60, 40], 40, stages, 90.0) == want
    # a start-up shorter than two steady epochs counts as none
    stages["joint"]["chunk_s"] = 20.0
    assert timed.estimate_s([0, 0, 1], 40, stages, 0.0) == 13.0


@pytest.mark.parametrize("seconds,want", [
    (1e6, ([100, 60, 40], 100)),
    (1e3, None),
    (100.0, ([1, 1, 1], 0)),
])
def test_fit_epochs(seconds, want):
    stages = timed.probe_times(_probe_results())
    epochs, pct = timed.fit_epochs([100, 60, 40], 40, stages, 90.0, seconds)
    if want is not None:
        assert (epochs, pct) == want
        return
    # the largest percentage that fits, each count rounded down
    assert 0 < pct < 100
    assert epochs == [100 * pct // 100, 60 * pct // 100, 40 * pct // 100]
    assert timed.estimate_s(epochs, 40, stages, 90.0) <= seconds
    above = [max(1, e * (pct + 1) // 100) for e in (100, 60, 40)]
    assert timed.estimate_s(above, 40, stages, 90.0) > seconds


@pytest.mark.parametrize("budget,cut", [(1e6, False), (1e3, True)])
def test_main_probes_runs_and_keeps_no_weights(monkeypatch, tmp_path,
                                               budget, cut):
    out, keep = tmp_path / "out", tmp_path / "keep"
    # a file of the caller's under --out, and a stale probe of the script's
    (out / "probe").mkdir(parents=True)
    (out / "metrics.json").write_text("tracked")
    (out / "probe" / "stale").write_text("")
    gen_calls, pr_calls = [], []

    def fake_gen(argv):
        gen_calls.append(argv)
        os.makedirs(argv[argv.index("--out") + 1])

    def fake_pr(argv):
        pr_calls.append(argv)
        run = argv[argv.index("--out") + 1]
        assert not os.path.exists(os.path.join(run, "stale"))
        stage = os.path.join(run, "stage1_detection", "2026-01-01T00:00:00")
        os.makedirs(stage)
        for f in ("log.txt", "scalars.jsonl", "out_config.yaml",
                  "model_last.npz", "model_last.opt.npz"):
            open(os.path.join(stage, f), "w").close()
        with open(os.path.join(run, "metrics.json"), "w") as f:
            json.dump({"run": len(pr_calls)}, f)
        return _probe_results()

    monkeypatch.setattr(gen, "main", fake_gen)
    monkeypatch.setattr(pr, "main", fake_pr)
    res = timed.main(["--out", str(out), "--keep", str(keep), "--device",
                      "cpu", "--train", "4", "--val", "1", "--budget",
                      str(budget)])

    data = str(out / "data")
    assert gen_calls == [["--out", data, "--train", "4", "--val", "1"]]
    assert pr_calls[0] == [
        "--root", data, "--out", str(out / "probe"), "--epochs", "2", "2",
        "2", "--batch", "8", "--chunk", "2", "--device", "cpu"]
    assert pr_calls[1] == [
        "--root", data, "--out", str(out / "run"), "--epochs",
        *map(str, res["epochs"]), "--batch", "8", "--chunk", "40",
        "--device", "cpu"]
    assert (res["percent"] < 100) == cut
    assert res["epochs"] == ([100, 60, 40] if not cut else
                             [e * res["percent"] // 100
                              for e in (100, 60, 40)])
    assert res["test_s"] == 90.0 and res["probe"]["joint"]["chunk_s"] == 39.0
    assert set(res["seconds"]) == {"build", "generate", "probe",
                                   "protocol_run", "total"}
    # the caller's file stays; the probe is gone; the run keeps its weights
    assert (out / "metrics.json").read_text() == "tracked"
    assert not (out / "probe").exists()
    assert (out / "run" / "stage1_detection" / "2026-01-01T00:00:00"
            / "model_last.npz").exists()
    kept = sorted(os.path.relpath(os.path.join(d, f), keep)
                  for d, _, fs in os.walk(keep) for f in fs)
    assert kept == ["metrics.json",
                    "stage1_detection/2026-01-01T00:00:00/log.txt",
                    "stage1_detection/2026-01-01T00:00:00/out_config.yaml",
                    "stage1_detection/2026-01-01T00:00:00/scalars.jsonl",
                    "timed.json"]
    assert json.loads((keep / "metrics.json").read_text()) == {"run": 2}
    assert json.loads((keep / "timed.json").read_text())["epochs"] == \
        res["epochs"]
