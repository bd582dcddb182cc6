"""The port's ShapeNet preparation (`rfdnet_tpu_torch.prep.shapenet`, at
`device='cpu'`: render and fusion through their plain versions) against
the JAX package's tool (`tools/prep/shapenet.py`), on the CPU at a small
size: resolution 32, 8 views for the fusion alone (`run` and the CLI
render the tool's fixed 100 views of 640 x 640).

Tolerances:
- watertight meshes from the two fusions: within 0.5 voxel (vertex by
  vertex where the faces are equal, which is what this input gives; a
  depth or TSDF value that flips under the host's FMA would move the
  level set by less than a voxel);
- `sample_model` given the same watertight mesh: every file equal (the
  npz files' arrays, the binvox and OFF files' bytes): the same numpy
  draws and copies of one containment and voxelizer source;
- `run` on one model and the CLI: the same files as the tool's
  `process_model` (at this size both fusions give the same watertight
  mesh, so every later stage has equal input).

`run`'s scheduling is also checked with fakes of its stages: the models
in flight (fused, host stages not ended) stay within JOBS_PER_WORKER a
worker, and an error of the device stage ends the run.
"""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from rfdnet_tpu.meshing.mesh import TriMesh as JTriMesh
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from rfdnet_tpu_torch.prep import shapenet as tshapenet
from tools.prep import shapenet as jshapenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "demo", "outputs", "scene0549_00")
RES = 32
VIEWS = 8
MODELS = ("proposal_107", "proposal_22")


def _mesh(name):
    return TriMesh.load(os.path.join(DEMO, f"{name}_mesh.ply"))


def _within_half_voxel(a, b, scale, res):
    assert np.array_equal(a.faces, b.faces), "faces differ"
    err = np.abs(a.vertices - b.vertices).max() / (scale / res)
    print(f"watertight meshes: {len(a.faces)} faces, largest vertex "
          f"distance {err} voxels")
    assert err <= 0.5


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_files(a_root, b_root):
    names = _files(a_root)
    assert names == _files(b_root) and names
    for rel in names:
        a, b = os.path.join(a_root, rel), os.path.join(b_root, rel)
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
                assert za[k].dtype == zb[k].dtype, rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_geometry_helpers_equal():
    np.testing.assert_array_equal(tshapenet.fibonacci_views(100),
                                  jshapenet.fibonacci_views(100))
    for eye in tshapenet.fibonacci_views(100) * 2.0:
        np.testing.assert_array_equal(tshapenet.look_at_pose(eye),
                                      jshapenet.look_at_pose(eye))
    mesh = _mesh("proposal_107")
    np.testing.assert_array_equal(
        tshapenet.sample_surface(mesh, 5000, np.random.RandomState(1)),
        jshapenet.sample_surface(JTriMesh(mesh.vertices, mesh.faces), 5000,
                                 np.random.RandomState(1)))


@pytest.mark.parametrize("name", MODELS)
def test_watertight_fuse_matches_tool(name):
    mesh = _mesh(name)
    got, loc, scale = tshapenet.watertight_fuse(
        mesh, resolution=RES, n_views=VIEWS, device="cpu")
    want, jloc, jscale = jshapenet.watertight_fuse(
        JTriMesh(mesh.vertices, mesh.faces), resolution=RES, n_views=VIEWS)
    np.testing.assert_array_equal(loc, jloc)
    assert scale == jscale
    _within_half_voxel(got, want, scale, RES)


def test_sample_model_files_equal(tmp_path):
    """Both tools' sample stage on the same watertight mesh (the JAX tool's
    fusion of a demo mesh) write the same files."""
    mesh = _mesh("proposal_107")
    wt, _, _ = jshapenet.watertight_fuse(JTriMesh(mesh.vertices, mesh.faces),
                                         resolution=RES, n_views=VIEWS)
    for side, make, fn in (("jax", JTriMesh, jshapenet.sample_model),
                           ("torch", TriMesh, tshapenet.sample_model)):
        dirs = {}
        for key, sub in tshapenet.OUT_DIRS[:4]:
            dirs[key] = str(tmp_path / side / sub / "cat")
            os.makedirs(dirs[key])
        fn(make(wt.vertices, wt.faces), dirs, "cat", "m")
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "torch"))
    occ = np.load(tmp_path / "torch" / "point" / "cat" / "m.npz")
    share = np.unpackbits(occ["occupancies"]).mean()
    assert 0.05 < share < 0.95


def test_process_model_matches_tool(tmp_path):
    """One model through every stage of `run` (resolution 32, the tools'
    100 views) against the tool's `process_model`: the same output tree
    and files."""
    src = tmp_path / "in" / "cat" / "m" / "model.off"
    os.makedirs(src.parent)
    _mesh("proposal_22").export(str(src))
    got = tshapenet.run(str(tmp_path / "in"), str(tmp_path / "torch"), RES,
                        500, workers=1, device="cpu")
    want = jshapenet.process_model(
        (str(src), str(tmp_path / "jax"), "cat", "m", RES, 500))
    assert [r[:4] for r in got] == [("cat", "m", True, "")]
    assert want == ("m", True, "")
    assert set(got[0][4]) == set(tshapenet.STAGES) | {"total"}
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "torch"))
    simple = TriMesh.load(str(
        tmp_path / "torch" / "watertight_scaled_simplified" / "cat" / "m.off"))
    assert 0 < len(simple.faces) <= 500


def test_cli_on_cpu_matches_tool(tmp_path, capsys):
    """`python -m rfdnet_tpu_torch.prep.shapenet --device cpu` over two
    models of one category (and a bad one, reported and skipped): the
    JAX tool's files, a stage line a model."""
    in_root = tmp_path / "in"
    for name in MODELS:
        os.makedirs(in_root / "cat" / name)
        _mesh(name).export(str(in_root / "cat" / name / "model.off"))
    os.makedirs(in_root / "cat" / "bad")
    (in_root / "cat" / "bad" / "model.off").write_text("OFF\n3 1 0\n")
    rc = tshapenet.main(["--in_root", str(in_root), "--out_root",
                         str(tmp_path / "torch"), "--resolution", str(RES),
                         "--nfaces", "800", "--workers", "2", "--device",
                         "cpu"])
    out = capsys.readouterr().out
    results = [json.loads(line) for line in out.splitlines()
               if line.startswith("{")]
    assert rc == 1  # a model failed
    assert [(r["model"], r["ok"]) for r in results] == [
        ("bad", False), (MODELS[0], True), (MODELS[1], True)]
    assert "FAILED bad:" in out
    assert set(results[1]["stage_ms"]) == set(tshapenet.STAGES) | {"total"}
    for name in MODELS:
        jshapenet.process_model((str(in_root / "cat" / name / "model.off"),
                                 str(tmp_path / "jax"), "cat", name, RES,
                                 800))
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "torch"))


def _fake_stages(monkeypatch, tmp_path, models, finish_s=0.0,
                 fuse_error=None):
    """`run` over `models` one-triangle models, with its pool on threads
    and fakes of its two stages: the device stage (raises `fuse_error` if
    given) and a host stage of `finish_s` seconds. Returns the largest
    number of models in flight seen."""
    for k in range(models):
        os.makedirs(tmp_path / "in" / "cat" / f"m{k:02d}")
        (tmp_path / "in" / "cat" / f"m{k:02d}" / "model.off").write_text(
            "OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    lock, live, seen = threading.Lock(), [0], [0]

    def fuse(mesh, resolution, device=None, ms=None):
        if fuse_error is not None:
            raise fuse_error
        with lock:
            live[0] += 1
            seen[0] = max(seen[0], live[0])
        return np.zeros((2, 2, 2), np.float32), 0.0, 1.0

    def finish(*args):
        time.sleep(finish_s)
        with lock:
            live[0] -= 1
        return {}, time.time()

    monkeypatch.setattr(tshapenet, "ProcessPoolExecutor",
                        lambda n, mp_context=None: ThreadPoolExecutor(n))
    monkeypatch.setattr(tshapenet, "fuse_tsdf", fuse)
    monkeypatch.setattr(tshapenet, "_finish_timed", finish)
    return seen


def test_run_bounds_models_in_flight(monkeypatch, tmp_path):
    """A host stage slower than the device stage: the parent fuses no
    further than JOBS_PER_WORKER models a worker ahead of the ended ones,
    so the grids it holds stay bounded, and every model ends in order."""
    seen = _fake_stages(monkeypatch, tmp_path, 24, finish_s=0.02)
    results = tshapenet.run(str(tmp_path / "in"), str(tmp_path / "out"),
                            workers=2, device="cpu")
    assert [(r[1], r[2]) for r in results] == [
        (f"m{k:02d}", True) for k in range(24)]
    print(f"models in flight: at most {seen[0]}")
    assert seen[0] == tshapenet.JOBS_PER_WORKER * 2


def test_run_raises_device_errors(monkeypatch, tmp_path):
    """An error of the device stage (as a kernel that fails to build or
    launch raises) ends the run; it is not reported as a bad model."""
    _fake_stages(monkeypatch, tmp_path, 3,
                 fuse_error=RuntimeError("kernel launch failed"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tshapenet.run(str(tmp_path / "in"), str(tmp_path / "out"),
                      workers=2, device="cpu")
