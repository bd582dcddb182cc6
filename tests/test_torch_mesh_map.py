"""The mesh mAP of the port against `rfdnet_tpu`'s, on the CPU: the native
surface voxelizer and interior fill, the mesh IoU, `eval_det`'s joint box
and mesh pass, the Tester with `evaluate_mesh_mAP`, and the synthetic
writer's GT meshes.

Tolerances:
- voxel arrays (`voxelize_surface`, `fill_interior`) are identical: both
  libraries are built from the same code with the same flags;
- `compute_mesh_iou` and `eval_det`'s (rec, prec, ap) are equal: the same
  float64 numpy arithmetic on identical voxels;
- `Tester.run`'s metrics, `mAP_mesh` and `AR_mesh` among them, are equal
  to 1e-6, the tolerance `test_torch_tester.py` holds the box mAP to;
- the synthetic writer's scenes are identical in content to the ones it
  wrote before the GT meshes were added (a digest pinned from that
  version), and each object's GT mesh is the closed cube of its occupied
  set.
"""

import hashlib
import importlib
import os
import pickle

import numpy as np
import pytest

from rfdnet_tpu.cli import _build_loaders as jbuild_loaders
from rfdnet_tpu.config.config import Config
from rfdnet_tpu.eval import mesh_iou as jmesh_iou
from rfdnet_tpu.eval import tester as jtester
from rfdnet_tpu.meshing import native as jnative
from rfdnet_tpu_torch import cli
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data.synthetic import box_mesh, write_scannet_scenes
from rfdnet_tpu_torch.eval import eval_det, mesh_iou
from rfdnet_tpu_torch.eval import tester as ttester
from rfdnet_tpu_torch.meshing import native as tnative
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from torch_parity import TEST_YAML, assert_equal, iscnet_pair

jeval_det = importlib.import_module("rfdnet_tpu.eval.eval_det")
LOW = 0.05  # a dump threshold that keeps valid slots with these weights


def _sphere():
    ax = np.linspace(-1, 1, 14)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    verts, tris = tnative.marching_cubes(0.7 - np.linalg.norm(g, axis=-1), 0)
    return verts / 13 - 0.5, tris


def _rotated_cube():
    verts, tris = box_mesh(0.3)
    a = 0.4
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    return verts @ R.T + [0.05, -0.02, 0.1], tris


MESHES = {"sphere": _sphere, "cube": box_mesh, "rotated_cube": _rotated_cube}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_voxelizer_arrays_identical(name):
    verts, tris = MESHES[name]()
    for size in (0.05, 0.13):
        mn = verts.min(0)
        dims = tuple(np.maximum(np.ceil((verts.max(0) - mn) / size)
                                .astype(int), 1) + 1)
        got = tnative.voxelize_surface(verts, tris, mn, size, dims)
        want = jnative.voxelize_surface(verts, tris, mn, size, dims)
        assert got.any()
        assert_equal(got, want, what=f"surface at {size}")
        interior = tnative.fill_interior(got)
        assert_equal(interior, jnative.fill_interior(want),
                     what=f"interior at {size}")
        assert interior.any() or size > 0.1
        assert not (interior & got).any()


def _pairs(module, size):
    """(interior, surface) pairs of `module` (either mesh_iou) for the
    meshes of MESHES, a shifted cube and an empty mesh."""
    out = {}
    for name, make in MESHES.items():
        out[name] = module.voxelize_mesh_pair(*make(), size)
    verts, tris = box_mesh()
    out["shifted_cube"] = module.voxelize_mesh_pair(verts + 0.2, tris, size)
    out["empty"] = module.voxelize_mesh_pair(np.zeros((0, 3)),
                                             np.zeros((0, 3), np.int32), size)
    return out


def test_compute_mesh_iou_equal():
    size = 0.04
    ours, theirs = _pairs(mesh_iou, size), _pairs(jmesh_iou, size)
    for a in ours:
        for b in ours:
            got = mesh_iou.mesh_iou(ours[a], ours[b])
            want = jmesh_iou.mesh_iou(theirs[a], theirs[b])
            assert got == want, (a, b)
            if a == b and a != "empty":
                assert got == 1.0
    assert mesh_iou.mesh_iou(None, ours["cube"]) == 0.0
    assert 0 < mesh_iou.mesh_iou(ours["cube"], ours["shifted_cube"]) < 1


def _det_inputs(module, seed: int):
    """Three scenes of two classes: GT (class, corners, mesh pair) and
    predictions (class, corners, score, mesh pair), boxes and meshes
    jittered from the GT's, some missing or empty."""
    rng = np.random.RandomState(seed)
    size = 0.05
    pairs = _pairs(module, size)
    names = ["sphere", "cube", "rotated_cube", "shifted_cube"]
    pred, gt = {}, {}
    for img in range(3):
        gt[img], pred[img] = [], []
        for k in range(3):
            cls = int(rng.randint(0, 2))
            corners = rng.uniform(-1, 1, (8, 3))
            name = names[rng.randint(0, len(names))]
            gt[img].append((cls, corners, pairs[name]))
            for _ in range(2):
                noisy = corners + rng.randn(8, 3) * 0.05
                guess = names[rng.randint(0, len(names))] if rng.rand() < 0.8 \
                    else "empty"
                pred[img].append((cls, noisy, float(rng.rand()),
                                  pairs[guess] if rng.rand() < 0.9 else None))
    return pred, gt


def _box_iou(a, b):
    """An axis-aligned IoU of corner sets: the test's `get_iou_func`."""
    lo = np.maximum(a.min(0), b.min(0))
    hi = np.minimum(a.max(0), b.max(0))
    inter = np.prod(np.clip(hi - lo, 0, None))
    vol = lambda c: np.prod(c.max(0) - c.min(0))
    return inter / (vol(a) + vol(b) - inter)


def test_eval_det_with_mesh_iou_matches_jax(monkeypatch):
    """The joint box and mesh pass, serially at two thresholds; then once
    in the spawned pool (`mesh_iou` pickles by name)."""
    monkeypatch.setattr(eval_det, "get_iou_obb", _box_iou)
    monkeypatch.setattr(jeval_det, "get_iou_obb", _box_iou)
    ours, theirs = _det_inputs(mesh_iou, 0), _det_inputs(jmesh_iou, 0)
    for thresh in (0.1, 0.25):
        got = eval_det.eval_det(*ours, ovthresh=thresh,
                                mesh_iou_func=mesh_iou.mesh_iou,
                                parallel=False)
        want = jeval_det.eval_det(*theirs, ovthresh=thresh,
                                  mesh_iou_func=jmesh_iou.mesh_iou,
                                  parallel=False)
        for g, w in zip(got, want):  # box, then mesh
            for gd, wd in zip(g, w):  # rec, prec, ap
                assert sorted(gd) == sorted(wd)
                for c in wd:
                    assert_equal(gd[c], wd[c], what=f"class {c}")
        assert any(v > 0 for v in got[1][2].values())
    spawned = eval_det.eval_det(*ours, ovthresh=0.25,
                                mesh_iou_func=mesh_iou.mesh_iou,
                                parallel=True)
    serial = eval_det.eval_det(*ours, ovthresh=0.25,
                               mesh_iou_func=mesh_iou.mesh_iou,
                               parallel=False)
    for g, w in zip(spawned, serial):
        for gd, wd in zip(g, w):
            for c in wd:
                assert_equal(gd[c], wd[c])


# ----------------------------------------------------------- the Tester
@pytest.fixture(scope="module")
def pair():
    return iscnet_pair(generate_limit=8)


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    return write_scannet_scenes(str(tmp_path_factory.mktemp("scannet")), 2,
                                seed=2, num_points=5000, num_objects=4)


def test_tester_mesh_map_matches_jax(pair, on_disk):
    """Both Testers with `evaluate_mesh_mAP` over the same two on-disk
    scenes (meshes at resolution 6, the refit, AP at 0.25): every metric,
    `mAP_mesh` and `AR_mesh` among them, within 1e-6."""
    model, variables, port = pair
    over = {"seed": 0, "weight": [], "data": {"num_point": 4096, **on_disk},
            "generation": {"dump_threshold": LOW, "resolution_0": 6},
            "test": {"ap_iou_thresholds": [0.25],
                     "evaluate_mesh_mAP": True}}
    jcfg = Config(TEST_YAML, mode="test", make_dirs=False)
    cfg = tconfig.load_config(TEST_YAML, mode="test")
    for c in (jcfg.config, cfg):
        tconfig.update_recursive(c, over)
    assert cfg == jcfg.config
    want = jtester.Tester(jcfg, model, variables, jcfg.dataset_config,
                          log=lambda m: None).run(
        jbuild_loaders(jcfg, ["test"])["test"], ap_iou_thresholds=[0.25])
    ours = ttester.Tester(cfg, port, log=lambda m: None)
    got = ours.run(cli._build_loaders(cfg, ["test"])["test"],
                   ap_iou_thresholds=[0.25])
    assert sorted(got) == sorted(want)
    assert "mAP_mesh @0.25" in got and "AR_mesh @0.25" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert all("voxelize" in ms for ms in ours.scene_ms)
    table = "\n".join(cli.format_ap_table(got, [0.25]))
    assert "mAP_mesh" in table and "AR_mesh" in table


# ------------------------------------------------------ synthetic scenes
# the content digest of `write_scannet_scenes(root, 2, seed=3, num_points=
# 3000, num_objects=3)` without the GT meshes, as the writer made it before
# it wrote them
WRITER_DIGEST = ("4a67c5e8d3767d0de218342c65a472eb"
                 "e5264d0b7b70005b9e401197521e5d30")
MESH_DIR = os.path.join("shapenet", "watertight_scaled_simplified")


def _content(path: str) -> bytes:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return b"".join(k.encode() + z[k].tobytes()
                            for k in sorted(z.files))
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            boxes = pickle.load(f)
        return repr([{k: (np.asarray(v).tobytes() if k == "box3D" else v)
                      for k, v in sorted(b.items())} for b in boxes]).encode()
    with open(path, "rb") as f:
        return f.read()


def test_synthetic_scenes_unchanged_plus_gt_cubes(tmp_path):
    paths = write_scannet_scenes(str(tmp_path), 2, seed=3, num_points=3000,
                                 num_objects=3)
    h, meshes = hashlib.sha256(), []
    for d, _, files in sorted(os.walk(tmp_path)):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(d, f), tmp_path)
            if rel.startswith(MESH_DIR):
                meshes.append(os.path.join(d, f))
            else:
                h.update(rel.encode() + _content(os.path.join(d, f)))
    assert h.hexdigest() == WRITER_DIGEST
    assert paths["shapenet_path"] == str(tmp_path / "shapenet")
    assert len(meshes) == 2 * 3
    verts, tris = box_mesh()
    assert np.abs(verts).max() == 0.45 and len(tris) == 12
    for path in meshes:
        m = TriMesh.load(path)
        assert_equal(m.vertices, verts)
        assert_equal(m.faces, tris)
    # closed: each edge in two faces; outward: positive signed volume
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 2).all()
    a, b, c = (verts[tris[:, i]] for i in range(3))
    assert np.isclose(np.einsum("ij,ij->", a, np.cross(b, c)) / 6, 0.9 ** 3)
