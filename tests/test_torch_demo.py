"""The demo entry point of the port against `rfdnet_tpu`'s on the CPU:
configuration reading, `demo.generate` (scan -> boxes -> meshes), the
dump, the CLI, the weight file, and the `vote_fps` / `random` samplings
with the detection configuration.

Tolerances:
- index and mask outputs are exact (sampling indices, NMS keep mask,
  proposal ids, valid flags), f32 outputs atol 3e-5, rtol 2e-4
  (`tests/test_parity_torch.py:41-42`), as in `tests/test_torch_slice.py`;
- meshes across the two packages: a lattice value close to the iso level
  (logit 0) may fall on either side of it and change a cell's case, so a
  proposal's meshes are compared only when `chip_smoke.mesh_comparable`
  says its two grids have the same signs everywhere and no edge crosses
  the level with a value difference under 1e-3: then faces are equal and
  vertices within the tolerance it returns (twice the grids' largest
  difference over the smallest crossing difference, in cells). The
  proposals left out are counted;
- dumps of both packages from the same inputs: npz arrays and PLY bytes
  equal.
"""

import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from rfdnet_tpu import demo as jdemo
from rfdnet_tpu.config.config import Config
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu.models import proposal as jproposal
from rfdnet_tpu_torch import cli, config as tconfig, demo, weights
from rfdnet_tpu_torch.meshing.generator import Generator3D
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from rfdnet_tpu_torch.models import ProposalModule
from rfdnet_tpu_torch.utils import profiling
from torch_parity import (
    TEST_YAML,
    apply_flax,
    assert_close,
    assert_equal,
    init_flax,
    iscnet_pair,
    load_port,
    perturb,
    scene,
    t,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
DETECTION_YAML = os.path.join(CONFIGS, "iscnet_detection.yaml")
ROOM = os.path.join(ROOT, "demo", "outputs", "synthetic_room",
                    "synthetic_room.off")
YAMLS = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".yaml"))
GRID = 8
OVERRIDES = {"generation": {"resolution_0": GRID, "dump_threshold": 0.05}}


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("name", YAMLS)
def test_parse_yaml_matches_pyyaml(name):
    text = open(os.path.join(CONFIGS, name)).read()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


def test_parse_yaml_scalars_and_flow_match_pyyaml():
    text = ("a: 1e-3 # a string to PyYAML\nb: [1, [2.5, x], {k: v, n: ~}]\n"
            "c:\n  - 'q: r'\n  - -3\n  - 1_000\nd: {}\ne: []\nf:\n"
            "g: 1.e-3\nh: 5.0e-05\ni: +.5e+1\nj: no\nk: \"# kept\"\n"
            "l: a b # c\nm:\n- 1\n- two\nn: .5\n")
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    assert tconfig.parse_yaml("") is None and tconfig.parse_yaml("# x") is None


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: |\n  text", "a:\n  - b: 1\n    c: 2", "a: [1,\n  2]",
    "a: 0x10", "a:\n\tb: 1", "a: 1\n   b: 2", "just a line", "a: .inf",
])
def test_parse_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="unsupported YAML"):
        tconfig.parse_yaml(text)


@pytest.mark.parametrize("mode", ["train", "val", "test", "demo"])
@pytest.mark.parametrize("name", YAMLS)
def test_load_config_and_eval_config_match_jax(name, mode):
    path = os.path.join(CONFIGS, name)
    want = Config(path, mode=mode, make_dirs=False)
    got = tconfig.load_config(path, mode=mode)
    assert got == want.config
    ec = tconfig.eval_config(got)
    assert ec == {k: want.eval_config[k] for k in ec}
    assert sorted(ec) == ["cls_nms", "conf_thresh", "nms_iou",
                          "per_class_proposal", "remove_empty_box"]


def test_load_config_from_dict_and_defaults():
    want = Config({"data": {"num_point": 7}}, mode="demo", make_dirs=False)
    assert tconfig.load_config({"data": {"num_point": 7}}, "demo") == (
        want.config)
    assert tconfig.load_config(None, "test") == Config(
        None, mode="test", make_dirs=False).config
    assert tconfig.DEFAULTS["mode"] == "train"  # the defaults are not edited
    with pytest.raises(TypeError):
        tconfig.load_config(3)


# ------------------------------------------------------------- the slice
def _jax_grid_points():
    from rfdnet_tpu.models.occnet import make_3d_grid

    return make_3d_grid((-0.5,) * 3, (0.5,) * 3, (GRID,) * 3)


@pytest.fixture(scope="module")
def pair():
    return iscnet_pair(generate_limit=8)


@pytest.fixture(scope="module")
def demo_outputs(pair):
    """(port cfg, data, port outputs, JAX outputs) of `demo.generate` on
    the 4096-point scene of seed 1, demo mode, low dump threshold."""
    model, variables, port = pair
    jcfg = Config(TEST_YAML, mode="demo", make_dirs=False)
    for section, values in OVERRIDES.items():
        jcfg.config[section].update(values)
    pc = scene(1)
    want = jdemo.generate(jcfg, model, variables, {"point_clouds": pc})
    cfg = tconfig.load_config(TEST_YAML, mode="demo")
    tconfig.update_recursive(cfg, OVERRIDES)
    assert cfg == jcfg.config
    data = {"point_clouds": t(pc)}
    return cfg, data, demo.generate(cfg, port, data), want


def test_generate_matches_jax_demo(pair, demo_outputs):
    cfg, data, (parsed, gen, meshes), (w_parsed, w_gen, w_meshes) = (
        demo_outputs)
    assert set(parsed) == set(w_parsed)
    for k in ("pred_sem_cls", "pred_mask"):
        assert isinstance(parsed[k], np.ndarray)
        assert_equal(parsed[k], w_parsed[k], what=k)
    for k in ("pred_corners_3d_upright_camera", "sem_cls_probs", "obj_prob",
              "heading_angles", "box_size"):
        assert isinstance(parsed[k], np.ndarray)
        assert_close(parsed[k], w_parsed[k], what=k)
    assert set(gen) == set(w_gen)
    for k in ("proposal_ids", "valid"):
        assert isinstance(gen[k], np.ndarray)
        assert_equal(gen[k], w_gen[k], what=k)
    for k in ("features", "cls_codes", "centers", "heading_angles",
              "mask_loss"):
        assert_close(gen[k], w_gen[k], what=k)
    # the decoder's inputs stay tensors on the model's device
    assert all(isinstance(gen[k], torch.Tensor)
               for k in ("features", "cls_codes"))

    valid = gen["valid"].reshape(-1)
    assert valid.sum() > 0 and len(meshes) == len(w_meshes) == 8
    generator = demo.make_generator(cfg, pair[2])
    grids = generator.decode_grids(gen["features"], gen["cls_codes"]).numpy()
    pts = 1.1 * np.asarray(_jax_grid_points())
    w_grids = np.asarray(pair[0].apply(
        pair[1], jnp.asarray(w_gen["features"]),
        jnp.asarray(w_gen["cls_codes"]),
        jnp.broadcast_to(pts[None], (8,) + pts.shape),
        method=ISCNet.decode_occupancy, mutable=False)).reshape(grids.shape)
    assert_close(grids, w_grids, what="grids")
    cell = 1.1 / (GRID - 1)
    compared = left_out = 0
    for g, (mesh, want) in enumerate(zip(meshes, w_meshes)):
        assert isinstance(mesh, TriMesh)
        assert mesh.vertices.dtype == np.float64
        assert mesh.faces.dtype == np.int32
        if not valid[g]:
            assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)
            assert len(want.vertices) == 0
            continue
        ok, tol_cells = chip_smoke.mesh_comparable(grids[g], w_grids[g],
                                                   generator.iso)
        if not ok:
            left_out += 1
            continue
        compared += 1
        np.testing.assert_array_equal(mesh.faces, want.faces)
        np.testing.assert_allclose(mesh.vertices, want.vertices,
                                   atol=tol_cells * cell + 1e-12, rtol=0)
    print(f"meshes compared {compared}, left out near the iso level "
          f"{left_out}")
    assert compared > 0 and compared + left_out == valid.sum()
    assert any(len(m.faces) for m in meshes)


def test_generate_reuses_the_generator_and_times_the_host(pair, demo_outputs):
    cfg, data, (parsed, gen, meshes), _ = demo_outputs
    generator = demo.make_generator(cfg, pair[2])
    with profiling.recording() as rec:
        again = demo.generate(cfg, pair[2], data, generator=generator)
    host_ms = {name: row["host_ms"] for name, row in
               rec.table()["spans"].items() if name.startswith("demo.")}
    assert sorted(host_ms) == ["demo.d2h", "demo.grid_decode", "demo.mesh"]
    assert all(v >= 0 for v in host_ms.values())
    for a, b in zip(again[2], meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
    # the refit moves boxes and nothing else
    refit = demo.generate(cfg, pair[2], data, generator=generator,
                          post_processing=True)
    assert_equal(refit[1]["proposal_ids"], gen["proposal_ids"])
    corners = "pred_corners_3d_upright_camera"
    assert np.abs(refit[0][corners] - parsed[corners]).max() > 0
    for k in ("obj_prob", "pred_mask"):
        assert_equal(refit[0][k], parsed[k], what=k)
    # use_sampling: the meshes of one prior draw of z a proposal
    sampled = copy.deepcopy(cfg)
    sampled["generation"]["use_sampling"] = True
    _, gen_s, meshes_s = demo.generate(sampled, pair[2], data)
    assert_equal(gen_s["valid"], gen["valid"])
    z = pair[2].sample_z(gen_s["features"].shape[0])
    want = Generator3D(functools.partial(pair[2].decode_occupancy, z=z),
                       resolution0=cfg["generation"]["resolution_0"]
                       ).generate_meshes(gen_s["features"],
                                         gen_s["cls_codes"],
                                         valid=gen_s["valid"].reshape(-1))
    assert any(len(m.faces) for m in meshes_s)
    for a, b in zip(meshes_s, want):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
    assert any(not np.array_equal(a.vertices, b.vertices)
               for a, b in zip(meshes_s, meshes) if len(a.faces))


def test_generate_grids_and_generate_agree(pair, demo_outputs):
    """`generate_grids` (the grids on the device, one `ISCNet.generate`)
    and `generate` (through `Generator3D`) see the same grids."""
    cfg, data, (parsed, gen, meshes), _ = demo_outputs
    ep, parsed_g, gen_g, grids = demo.generate_grids(
        cfg, pair[2], data["point_clouds"])
    assert_equal(parsed_g["pred_mask"], parsed["pred_mask"])
    assert_equal(gen_g["proposal_ids"], gen["proposal_ids"])
    from_grids = demo.make_generator(cfg, pair[2]).meshes_from_grids(
        grids, valid=gen_g["valid"].reshape(-1))
    for a, b in zip(from_grids, meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)


def _png_mask(path):
    """Non-background pixels of a PNG (any color channel below 250/255)."""
    import matplotlib.image

    img = matplotlib.image.imread(path)
    return (img[..., :3] < 250 / 255).any(-1)


def _dilate(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


# pred.png: at least this share of each render's non-background pixels lies
# within 3 pixels of the other's
PNG_OVERLAP = 0.9


def test_save_visualization_matches_jax(demo_outputs, tmp_path):
    """The demo's whole file set against JAX's: every file byte-identical
    (`scene.html` included), except `pred.png` (the port's numpy render
    against JAX's matplotlib one: their non-background pixels overlap, see
    PNG_OVERLAP)."""
    cfg, data, (parsed, gen, meshes), _ = demo_outputs
    got_dir = demo.save_visualization(data, parsed, gen, meshes,
                                      str(tmp_path / "port" / "scene"))
    demo.visualize(data, parsed, gen, meshes,
                   os.path.join(got_dir, "pred.png"))
    np_data = {"point_clouds": data["point_clouds"].numpy()}
    want_dir = jdemo.save_visualization(None, np_data, parsed, gen, meshes,
                                        str(tmp_path / "jax" / "scene"))
    jdemo.visualize(np_data, parsed, gen, meshes,
                    os.path.join(want_dir, "pred.png"))
    got_files = sorted(os.listdir(got_dir))
    assert got_files == sorted(os.listdir(want_dir))
    n_valid = int(gen["valid"].sum())
    n_meshes = sum(bool(v) and len(m.vertices) > 0
                   for v, m in zip(gen["valid"][0], meshes))
    assert len(got_files) == 4 + n_meshes and n_meshes > 0
    for name in got_files:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files) == [
                "obbs", "proposal_map"]
            assert za["obbs"].shape == (n_valid, 7)
            assert za["proposal_map"].shape == (n_valid, 1)
            for k in za.files:
                assert_equal(za[k], zb[k], what=k)
        elif name == "pred.png":
            ma, mb = _png_mask(a), _png_mask(b)
            assert ma.shape == mb.shape == (960, 1200)
            assert (ma & _dilate(mb, 3)).sum() >= PNG_OVERLAP * ma.sum()
            assert (mb & _dilate(ma, 3)).sum() >= PNG_OVERLAP * mb.sum()
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name
    scan = TriMesh.load(os.path.join(got_dir, "000000_pc.ply"))
    assert scan.vertices.shape == (4096, 3) and scan.faces.shape == (0, 3)


def test_save_visualization_keeps_the_box_of_an_empty_mesh(demo_outputs,
                                                           tmp_path):
    cfg, data, (parsed, gen, meshes), _ = demo_outputs
    empty = [TriMesh(np.zeros((0, 3)), np.zeros((0, 3))) for _ in meshes]
    out = demo.save_visualization(data, parsed, gen, empty, str(tmp_path))
    assert sorted(os.listdir(out)) == [
        "000000_pc.ply", "000000_pred_confident_nms_bbox.npz", "scene.html"]
    z = np.load(os.path.join(out, "000000_pred_confident_nms_bbox.npz"))
    assert z["obbs"].shape == (int(gen["valid"].sum()), 7)


def test_load_demo_data_reads_ply_as_jax(tmp_path):
    mesh = TriMesh.load(ROOM)
    ply = str(tmp_path / "room.ply")
    mesh.export(ply)
    want = jdemo.load_demo_data(ply, num_points=5000)["point_clouds"]
    got = demo.load_demo_data(ply, num_points=5000, device="cpu")
    assert_equal(got["point_clouds"], want)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        demo.load_demo_data(str(tmp_path / "room.obj"), device="cpu")


# --------------------------------------------------------------- weights
def _flat(variables):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import export_torch_weights
    finally:
        sys.path.pop(0)
    flat = export_torch_weights.flatten(variables["params"], "params")
    flat.update(export_torch_weights.flatten(variables["batch_stats"],
                                             "batch_stats"))
    return export_torch_weights, flat


def test_exported_checkpoint_loads_into_the_port(pair, demo_outputs, tmp_path):
    """flax variables -> `CheckpointIO` (orbax) -> the export tool -> the
    port's `load_npz`: the same weights as the in-memory bridge, and the
    same grids as the JAX package from the restored checkpoint."""
    from rfdnet_tpu.train.checkpoint import CheckpointIO

    model, variables, port = pair
    tool, _ = _flat(variables)
    ckpt = CheckpointIO(str(tmp_path / "run"), log=lambda m: None)
    ckpt.save("model_best", {"params": variables["params"],
                             "batch_stats": variables["batch_stats"],
                             "step": np.int32(3)})
    out = tool.export(str(tmp_path / "run" / "model_best"))
    assert out == str(tmp_path / "run" / "model_best.npz")
    assert tool.main([str(tmp_path / "run" / "model_best"), "--out",
                      str(tmp_path / "w.npz")]) == 0

    fresh = tconfig.build_model(generate_limit=8, device="cpu")
    weights.init_seeded(fresh, 5)
    lines = []
    weights.load_npz(fresh, str(tmp_path / "w.npz"), log=lines.append)
    assert lines[0] == "set() subnet missed."
    assert "backbone" in lines[1] and "completion" in lines[1]
    want_state = port.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want_state[k]), k

    cfg, data, _, _ = demo_outputs
    restored, _ = ckpt.load(str(tmp_path / "run" / "model_best"))
    ec = tconfig.eval_config(cfg)
    want = jax.jit(lambda v, x: model.apply(
        v, {"point_clouds": x}, method=ISCNet.generate,
        nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
        dump_threshold=cfg["generation"]["dump_threshold"],
        remove_empty_box=ec["remove_empty_box"], decode_grid_res=GRID,
    ))({"params": restored["params"],
        "batch_stats": restored["batch_stats"]},
       jnp.asarray(data["point_clouds"].numpy()))
    _, parsed, gen, grids = demo.generate_grids(cfg, fresh,
                                                data["point_clouds"])
    assert_equal(parsed["pred_mask"], want["parsed"]["pred_mask"])
    assert_equal(gen["proposal_ids"], want["gen"]["proposal_ids"])
    assert_equal(gen["valid"], want["gen"]["valid"])
    assert_close(grids, want["grids"], what="grids")


def test_load_npz_partial_load_reports_missed_subnets(pair, tmp_path):
    _, variables, port = pair
    _, flat = _flat(variables)
    wrong = "params/detection/conv3/kernel"
    partial = {k: v for k, v in flat.items()
               if not k.split("/")[1] == "completion"}
    partial[wrong] = partial[wrong][:, :5]          # another shape: skipped
    np.savez(str(tmp_path / "partial.npz"), **partial)
    fresh = tconfig.build_model(generate_limit=8, device="cpu")
    weights.init_seeded(fresh, 5)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    lines = []
    weights.load_npz(fresh, str(tmp_path / "partial.npz"), log=lines.append)
    assert lines[0].endswith("subnet missed.")
    assert "'completion'" in lines[0] and "'detection'" in lines[0]
    assert "'backbone'" in lines[1] and "'completion'" not in lines[1]
    want_state = port.state_dict()
    for k, v in fresh.state_dict().items():
        kept = k.startswith("completion.") or k == "detection.conv3.weight"
        assert torch.equal(v, before[k] if kept else want_state[k]), k
    np.savez(str(tmp_path / "bad.npz"), **{"opt_state/x/y": np.zeros(2)})
    with pytest.raises(ValueError, match="unexpected key"):
        weights.load_npz(fresh, str(tmp_path / "bad.npz"))


# ------------------------------------------------------------------- CLI
SMALL_YAML = """\
# a narrow demo configuration for the CPU
seed: 10
weight:
- {weight}
data:
  num_point: 2048
generation:
  resolution_0: 6
  dump_threshold: 0.05
demo:
  phase: completion
"""


def test_cli_demo_on_cpu_writes_the_files(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(SMALL_YAML.format(weight="weights/none"))
    out = cli.main(["--config", str(cfg_path), "--mode", "demo",
                    "--demo_path", ROOM, "--device", "cpu"])
    assert out == os.path.join("out/demo", "visualization", "synthetic_room")
    files = sorted(os.listdir(tmp_path / out))
    for name in ("000000_pc.ply", "000000_pred_confident_nms_bbox.npz",
                 "scene.html", "pred.png"):
        assert name in files and os.path.getsize(tmp_path / out / name) > 0
    z = np.load(tmp_path / out / "000000_pred_confident_nms_bbox.npz")
    k = z["obbs"].shape[0]
    assert z["obbs"].shape == (k, 7) and z["proposal_map"].shape == (k, 1)
    assert 0 < k <= 64
    plys = [f for f in files if f.startswith("proposal_")]
    assert 0 < len(plys) <= k
    ids = {int(f.split("_")[1]) for f in plys}
    assert ids <= set(z["proposal_map"][:, 0].tolist())
    for f in plys[:3]:
        mesh = TriMesh.load(str(tmp_path / out / f))
        assert len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()
    scan = TriMesh.load(str(tmp_path / out / "000000_pc.ply"))
    assert scan.vertices.shape == (2048, 3)
    printed = capsys.readouterr().out
    assert "mode: demo" in printed
    assert "Warning: weight path weights/none not found." in printed


def test_cli_loads_the_npz_beside_a_weight_path(pair, tmp_path):
    _, variables, port = pair
    _, flat = _flat(variables)
    os.makedirs(tmp_path / "w")
    np.savez(str(tmp_path / "w" / "model_best.npz"), **flat)
    cfg = tconfig.load_config(
        {"weight": [str(tmp_path / "w" / "model_best")]}, "demo")
    lines = []
    model = cli.restore_weights(
        cfg, tconfig.build_model(cfg, generate_limit=8, device="cpu"),
        log=lines.append)
    assert lines[0] == "set() subnet missed."
    want_state = port.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_state[k]), k


@pytest.mark.parametrize("mode, item", [("train", "Training")])
def test_cli_unported_modes_raise(mode, item, monkeypatch, tmp_path):
    """No mode of the CLI is left unported: `--mode train` (the ROADMAP
    item `item`) now runs, and with the test config it stops only at the
    dataset, whose split the repository does not hold."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=f"scannetv2_{mode}.json"):
        cli.main(["--config", TEST_YAML, "--mode", mode, "--device", "cpu"])


def test_cli_without_a_card_or_a_device_raises(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", TEST_YAML, "--mode", "demo", "--demo_path",
                  ROOM])
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- samplings, detection
def _votes(seed):
    rng = np.random.RandomState(seed)
    seeds = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    votes = seeds + rng.normal(0, 0.2, seeds.shape).astype(np.float32)
    return seeds, votes, rng.randn(2, 300, 256).astype(np.float32)


def _assert_proposal_outputs(got, want):
    (g_out, g_pf), (w_out, w_pf) = got, want
    assert_equal(g_out["aggregated_vote_inds"], w_out["aggregated_vote_inds"])
    assert g_out["aggregated_vote_inds"].dtype == torch.int32
    assert_close(g_pf, w_pf)
    for k, v in w_out.items():
        if k != "aggregated_vote_inds":
            assert_close(g_out[k], v, what=k)


def test_vote_fps_sampling_matches_jax():
    seeds, votes, feats = _votes(11)
    jp = jproposal.ProposalModule(num_proposal=32, sampling="vote_fps",
                                  fps_impl="xla")
    args = (jnp.asarray(votes), jnp.asarray(feats),
            {"seed_xyz": jnp.asarray(seeds)}, False)
    vs = init_flax(jp, 7, *args)
    want = apply_flax(jp, vs, *args)
    port = load_port(ProposalModule(num_proposal=32, sampling="vote_fps"), vs)
    got = port(t(votes), t(feats), {"seed_xyz": t(seeds)})
    _assert_proposal_outputs(got, want)
    # the votes were sampled, not the seeds
    by_seeds = load_port(ProposalModule(num_proposal=32), vs)(
        t(votes), t(feats), {"seed_xyz": t(seeds)})[0]
    assert not torch.equal(by_seeds["aggregated_vote_inds"],
                           got[0]["aggregated_vote_inds"])


def test_random_sampling_with_injected_indices_matches_jax(monkeypatch):
    seeds, votes, feats = _votes(12)
    key = jax.random.PRNGKey(3)
    jp = jproposal.ProposalModule(num_proposal=32, sampling="random")
    args = (jnp.asarray(votes), jnp.asarray(feats),
            {"seed_xyz": jnp.asarray(seeds)}, False)
    vs = init_flax(jp, 8, *args, rng=key)
    want = apply_flax(jp, vs, *args, rng=key)
    inds = np.asarray(want[0]["aggregated_vote_inds"])
    port = load_port(ProposalModule(num_proposal=32, sampling="random"), vs)

    # the port draws from a torch.Generator, whose stream is not JAX's:
    # hand it the indices JAX drew
    def randint(low, high, size, generator, dtype, device):
        assert (low, high, tuple(size)) == (0, 300, (2, 32))
        return torch.from_numpy(inds.copy()).to(dtype)

    with monkeypatch.context() as m:
        m.setattr(torch, "randint", randint)
        got = port(t(votes), t(feats), {"seed_xyz": t(seeds)},
                   generator=torch.Generator().manual_seed(0))
    _assert_proposal_outputs(got, want)

    # its own draws: in range, repeatable from the generator's seed
    a, b = (port(t(votes), t(feats), {"seed_xyz": t(seeds)},
                 generator=torch.Generator().manual_seed(4))[0]
            ["aggregated_vote_inds"] for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 32)
    assert int(a.min()) >= 0 and int(a.max()) < 300
    with pytest.raises(ValueError, match="requires a generator"):
        port(t(votes), t(feats), {"seed_xyz": t(seeds)})
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        ProposalModule(sampling="grid")


def test_detection_config_matches_jax():
    """`configs/iscnet_detection.yaml` in demo mode: phase detection,
    `vote_fps`, no completion modules; `ISCNet.generate` gives detections
    and the NMS mask only."""
    jcfg = Config(DETECTION_YAML, mode="demo", make_dirs=False)
    model = jcfg.build_model()
    pc = scene(1)
    variables = perturb(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), {"point_clouds": x}, method=ISCNet.generate,
    ))(jnp.asarray(pc)), 0)
    ec = jcfg.eval_config
    want = jax.jit(lambda v, x: model.apply(
        v, {"point_clouds": x}, method=ISCNet.generate,
        nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
        remove_empty_box=ec["remove_empty_box"],
    ))(variables, jnp.asarray(pc))

    cfg = tconfig.load_config(DETECTION_YAML, mode="demo")
    assert cfg["data"]["cluster_sampling"] == "vote_fps"
    port = load_port(tconfig.build_model(cfg, device="cpu"), variables)
    assert port.phase == "detection" and not hasattr(port, "completion")
    end_points, parsed, gen, grids = demo.generate_grids(cfg, port, t(pc))
    assert gen is None and grids is None
    assert set(end_points) == set(want["end_points"])
    for k, v in want["end_points"].items():
        if k.endswith("_inds"):
            assert_equal(end_points[k], v, what=k)
        else:
            assert_close(end_points[k], v, what=k)
    assert set(parsed) == set(want["parsed"])
    for k, v in want["parsed"].items():
        if k in ("pred_sem_cls", "pred_mask"):
            assert_equal(parsed[k], v, what=k)
        else:
            assert_close(parsed[k], v, what=k)
    assert 0 < int(parsed["pred_mask"].sum()) <= 256
    with pytest.raises(ValueError, match="detection phase"):
        demo.generate(cfg, port, {"point_clouds": t(pc)})
