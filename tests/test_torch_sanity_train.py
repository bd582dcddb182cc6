"""`rfdnet_tpu_torch.tools.sanity_train` against the JAX tool
`tools/sanity_train.py`, on the CPU: its scenes and batch order, its
Tester config, one detection step through its step loop against the JAX
step (`torch_parity.check_sanity_step`; the frozen completion step is
`test_torch_sanity_train_completion.py`, a file of its own so that the two
JAX train-step compiles run on different workers), and its `main` end to
end: save, then fine-tune with the detector frozen.
"""

import functools
import os

import numpy as np
import pytest

from rfdnet_tpu.config.config import Config
from rfdnet_tpu.config.scannet import ScannetConfig
from rfdnet_tpu.data.synthetic import synthetic_scene_batch
from rfdnet_tpu_torch.config import eval_config
from rfdnet_tpu_torch.tools import sanity_train as st
from torch_parity import SANITY_FROZEN, SANITY_WIDTHS, check_sanity_step


@pytest.mark.parametrize("scenes,batch,points,steps", [
    (32, 8, 20000, 9),   # the tool's defaults: a shuffle every 4 steps
    (6, 4, 1024, 5),     # a pass of one step, a scene never drawn
])
def test_scenes_and_order_match_jax_tool(scenes, batch, points, steps):
    dc = ScannetConfig()
    # the JAX tool's draws (tools/sanity_train.py:77-83, 108-115)
    rng = np.random.RandomState(0)
    want = [synthetic_scene_batch(rng, batch_size=1, num_points=points,
                                  num_objects=4, mean_size_arr=dc.mean_size_arr)
            for _ in range(scenes + 4)]
    want_order = []
    order = np.arange(scenes)
    for it in range(steps):
        if it % (scenes // batch) == 0:
            rng.shuffle(order)
        want_order.append(
            order[(it % (scenes // batch)) * batch:][:batch].copy())

    trng = np.random.RandomState(0)
    train, val = st.make_scenes(trng, scenes, points)
    got_order = [sel.copy() for sel in st.batch_order(trng, scenes, batch,
                                                      steps)]
    assert len(train) == scenes and len(val) == st.VAL_SCENES == 4
    for i, (g, w) in enumerate(zip(train + val, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    for g, w in zip(got_order, want_order, strict=True):
        np.testing.assert_array_equal(g, w)


# what the port's Tester reads of its config (eval/tester.py, and the
# generator's settings, which it reads only with meshes)
_TESTER_KEYS = {
    "data": ("num_point", "threshold", "decoder_bf16"),
    "generation": ("generate_mesh", "dump_threshold", "decoder_impl",
                   "use_sampling", "resolution_0", "upsampling_steps",
                   "refinement_step", "simplify_nfaces"),
    "test": ("phase", "batch_size", "ap_iou_thresholds", "evaluate_mesh_mAP"),
}


@pytest.mark.parametrize("phase", ["detection", "completion"])
def test_tester_config_matches_jax_tool(phase):
    # tools/sanity_train.py:57-68, without log.path (no Tester reads it)
    jcfg = Config({
        "data": {"num_point": 20000},
        "test": {"phase": phase, "batch_size": 1,
                 "ap_iou_thresholds": [0.25]},
        "generation": {"generate_mesh": False},
        "log": {"path": "/tmp/sanity_train"},
    }, mode="test", make_dirs=False)
    cfg = st.tester_config(20000, phase)
    assert cfg["mode"] == jcfg.config["mode"] == "test"
    for section, keys in _TESTER_KEYS.items():
        for k in keys:
            assert (cfg[section].get(k) == jcfg.config[section].get(k)), (
                section, k)
    ec = eval_config(cfg)
    for k, v in ec.items():
        assert jcfg.eval_config[k] == v, k


def test_detection_step_matches_jax():
    check_sanity_step("detection")


def test_main_saves_then_finetunes_frozen(tmp_path, capsys, monkeypatch):
    """The tool's `main` at a CPU size (narrow widths): detection with
    `--save-to`, then completion from it with the detector frozen. The
    frozen parameters come out bit-equal, and each run prints the keys the
    JAX tool prints (every mAP, AR and voxel IoU key)."""
    monkeypatch.setattr(st, "build_model", functools.partial(
        st.build_model, **SANITY_WIDTHS))
    common = ["--device", "cpu", "--steps", "2", "--scenes", "2",
              "--batch", "1", "--points", "1024"]
    det = str(tmp_path / "det")
    comp = str(tmp_path / "comp")
    class_names = set(ScannetConfig().class2type.values())

    def printed_keys(out: str) -> list:
        return [line.rsplit(":", 1)[0] for line in out.splitlines()
                if "@0.25:" in line or "voxel IoU:" in line]

    m1 = st.main([*common, "--save-to", det])
    out = capsys.readouterr().out
    assert "step 0: total" in out and "trained 2 steps" in out
    assert printed_keys(out) == ["mAP @0.25", "AR @0.25"]
    assert [k for k in m1 if "mAP" in k or "AR" in k
            or "voxel IoU" in k] == printed_keys(out)
    for suffix in (".npz", ".opt.npz", ".json"):
        assert os.path.isfile(det + suffix)

    m2 = st.main([*common, "--phase", "completion", "--finetune-from", det,
                  "--freeze", ",".join(SANITY_FROZEN), "--save-to", comp])
    out = capsys.readouterr().out
    assert " compl " in out
    keys = printed_keys(out)
    assert keys[:2] == ["mAP @0.25", "AR @0.25"] and len(keys) > 2
    assert all(k.endswith(" voxel IoU") and k[:-len(" voxel IoU")]
               in class_names for k in keys[2:])
    assert [k for k in m2 if "mAP" in k or "AR" in k
            or "voxel IoU" in k] == keys
    with np.load(det + ".npz") as a, np.load(comp + ".npz") as b:
        frozen = [k for k in a.files if k.startswith("params/")
                  and k.split("/")[1] in SANITY_FROZEN]
        assert frozen
        for k in frozen:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_voxel_iou_of_a_scene_without_valid_slots():
    """A scene whose slots are all below the dump threshold (an early
    completion model's) gives the Tester no voxels to score: an empty
    IoU, where the JAX Tester's `compute_iou` raises on the reshape."""
    from rfdnet_tpu.eval.tester import compute_iou as jax_iou
    from rfdnet_tpu_torch.eval.tester import compute_iou

    empty = np.zeros((0, 16, 16, 16), np.float32)
    assert compute_iou(empty, empty).shape == (0,)
    with pytest.raises(ValueError):
        jax_iou(empty, empty)
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 16, 16, 16), rng.rand(3, 16, 16, 16)
    np.testing.assert_array_equal(compute_iou(a, b), jax_iou(a, b))
