"""The port's host meshing (`rfdnet_tpu_torch.meshing`, `.eval`) against
`rfdnet_tpu`'s on the CPU, on grids and boxes made from a numpy seed.

Tolerances:
- the extractors and `Generator3D` on identical grids: arrays identical
  (same dtype, shape and bytes); both libraries are built from copies of
  one source with the same flags on this host;
- mesh files: bytes identical, and read back identically by both packages;
- box and placement helpers (float64 numpy on both sides): atol 1e-12;
- `generate_meshes` through a torch and a jnp decode function (float32,
  which may differ in the last place): faces equal, vertices atol 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.eval import box_util as jbox
from rfdnet_tpu.eval import refit as jrefit
from rfdnet_tpu.eval import tester as jtester
from rfdnet_tpu.meshing import generator as jgenerator
from rfdnet_tpu.meshing import mesh as jmesh
from rfdnet_tpu.meshing import native as jnative
from rfdnet_tpu_torch.eval import box_util as tbox
from rfdnet_tpu_torch.eval import refit as trefit
from rfdnet_tpu_torch.eval import tester as ttester
from rfdnet_tpu_torch.meshing import generator as tgenerator
from rfdnet_tpu_torch.meshing import mesh as tmesh
from rfdnet_tpu_torch.meshing import native as tnative
from rfdnet_tpu_torch.ops import _native

R = 12


def _sphere(shape, center, radius):
    axes = [np.linspace(-0.5, 0.5, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                + (z - center[2]) ** 2)
    return ((radius - d) * 20.0).astype(np.float32)


def _grids():
    """name -> (nx, ny, nz) float32 logit grid; iso level 0."""
    rng = np.random.RandomState(0)
    c = rng.uniform(-0.1, 0.1, 3)
    return {
        "sphere": _sphere((R,) * 3, c, 0.3),
        # two spheres that touch: ambiguous faces between them
        "touching": np.maximum(_sphere((R,) * 3, (-0.2, 0, 0), 0.2),
                               _sphere((R,) * 3, (0.2, 0, 0), 0.2)),
        "outside": np.full((R,) * 3, -1.0, np.float32),
        # all inside: only the -1e6 pad closes it
        "inside": np.full((R,) * 3, 1.0, np.float32),
        # every case of the table, ambiguous ones included
        "noise": rng.randn(R, R, R).astype(np.float32),
        "oblong": _sphere((8, 10, 13), c, 0.35),
    }


GRIDS = _grids()
CUBES = [k for k, g in GRIDS.items() if g.shape == (R,) * 3]


def assert_identical(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def assert_pairs_identical(got, want):
    assert len(got) == len(want)
    for i, ((gv, gt), (wv, wt)) in enumerate(zip(got, want)):
        assert_identical(gv, wv, f"verts {i}")
        assert_identical(gt, wt, f"tris {i}")


def assert_meshes_identical(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_identical(g.vertices, w.vertices, f"vertices {i}")
        assert_identical(g.faces, w.faces, f"faces {i}")
        assert g.vertex_normals is None and w.vertex_normals is None


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_cubes_matches_jax(name):
    grid = GRIDS[name]
    got = tnative.marching_cubes(grid, 0.0)
    assert_pairs_identical([got], [jnative.marching_cubes(grid, 0.0)])
    assert (len(got[0]) == 0) == (name in ("outside", "inside"))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_cubes_padded_matches_jax_and_explicit_pad(name):
    grid = GRIDS[name]
    got = tnative.marching_cubes_padded(grid, 0.0)
    assert_pairs_identical([got], [jnative.marching_cubes_padded(grid, 0.0)])
    padded = np.pad(grid, 1, mode="constant", constant_values=-1e6)
    assert_pairs_identical([got], [tnative.marching_cubes(padded, 0.0)])
    assert (len(got[0]) == 0) == (name == "outside")


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("masked", [False, True])
def test_marching_cubes_batch_matches_jax(monkeypatch, threads, masked):
    monkeypatch.setenv("RFDNET_MESH_THREADS", threads)
    grids = np.stack([GRIDS[k] for k in CUBES])
    valid = np.array([True, False, True, True, False]) if masked else None
    assert tnative.mesh_threads(len(grids)) == int(threads)
    got = tnative.marching_cubes_batch(grids, 0.0, valid=valid)
    assert_pairs_identical(
        got, jnative.marching_cubes_batch(grids, 0.0, valid=valid))
    for i, name in enumerate(CUBES):
        if masked and not valid[i]:
            assert got[i][0].shape == (0, 3) and got[i][1].shape == (0, 3)
        else:
            assert_pairs_identical(
                [got[i]], [tnative.marching_cubes_padded(GRIDS[name], 0.0)])


def test_extractors_reject_bad_shapes():
    with pytest.raises(ValueError, match="grid shape"):
        tnative.marching_cubes(np.zeros((4, 4), np.float32), 0.0)
    with pytest.raises(ValueError, match="grid shape"):
        tnative.marching_cubes_batch(np.zeros((4, 4, 4), np.float32), 0.0)
    with pytest.raises(ValueError, match="valid has"):
        tnative.marching_cubes_batch(np.zeros((2, 4, 4, 4), np.float32), 0.0,
                                     valid=[True])


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("masked", [False, True])
def test_meshes_from_grids_matches_jax(monkeypatch, threads, masked):
    """Both routes (one native call over worker threads; proposal by
    proposal on one core) against the JAX package's, and so each other."""
    monkeypatch.setenv("RFDNET_MESH_THREADS", threads)
    grids = np.stack([GRIDS[k] for k in CUBES])
    valid = np.array([True, True, False, True, True]) if masked else None
    got = tgenerator.Generator3D(None).meshes_from_grids(grids, valid=valid)
    want = jgenerator.Generator3D(None).meshes_from_grids(grids, valid=valid)
    assert_meshes_identical(got, want)
    assert got[0].vertices.dtype == np.float64
    assert got[0].faces.dtype == np.int32
    assert len(got[0].faces) > 0
    for i, m in enumerate(got):
        if CUBES[i] == "outside" or (masked and not valid[i]):
            assert m.vertices.shape == (0, 3) and m.faces.shape == (0, 3)
        else:
            # inside the padded unit box, the pad's layer included
            limit = 0.55 * (1 + 1.0 / (R - 1))
            assert np.abs(m.vertices).max() <= limit + 1e-9


def test_meshes_from_grids_routes_identical(monkeypatch):
    grids = np.stack([GRIDS[k] for k in CUBES])
    gen = tgenerator.Generator3D(None)
    monkeypatch.setenv("RFDNET_MESH_THREADS", "1")
    one = gen.meshes_from_grids(grids)
    monkeypatch.setenv("RFDNET_MESH_THREADS", "3")
    assert_meshes_identical(gen.meshes_from_grids(grids), one)
    assert_meshes_identical(gen.meshes_from_grids(torch.from_numpy(grids)),
                            one)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_extract_mesh_matches_jax(name):
    got = tgenerator.Generator3D(None).extract_mesh(GRIDS[name])
    want = jgenerator.Generator3D(None).extract_mesh(GRIDS[name])
    assert_meshes_identical([got], [want])


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_iso_level_matches_jax(threshold):
    grids = np.stack([GRIDS["sphere"], GRIDS["noise"]])
    got = tgenerator.Generator3D(None, threshold=threshold)
    want = jgenerator.Generator3D(None, threshold=threshold)
    assert_meshes_identical(got.meshes_from_grids(grids),
                            want.meshes_from_grids(grids))


def test_generate_meshes_matches_jax():
    """The whole dense path with a decode function written in torch and
    in jnp: a sphere per proposal, its centre in `features`."""
    rng = np.random.RandomState(1)
    features = rng.uniform(-0.15, 0.15, (3, 3)).astype(np.float32)
    cls_codes = np.zeros((3, 8), np.float32)
    valid = np.array([True, False, True])

    def decode_torch(f, c, p):
        return (0.3 - torch.linalg.vector_norm(p - f[:, None, :], dim=-1)) * 9

    def decode_jax(f, c, p):
        return (0.3 - jnp.linalg.norm(p - f[:, None, :], axis=-1)) * 9

    got = tgenerator.Generator3D(decode_torch, resolution0=10).generate_meshes(
        torch.from_numpy(features), torch.from_numpy(cls_codes),
        valid=torch.from_numpy(valid))
    want = jgenerator.Generator3D(decode_jax, resolution0=10).generate_meshes(
        features, cls_codes, valid=valid)
    assert [len(m.faces) for m in got] == [len(m.faces) for m in want]
    assert len(got[0].faces) > 0 and len(got[1].faces) == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.faces, w.faces)
        np.testing.assert_allclose(g.vertices, w.vertices, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kwargs, item", [
    ({"upsampling_steps": 2, "mise_budgets": [1024, 4096]}, "MISE"),
])
def test_unported_generator_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        tgenerator.Generator3D(None, **kwargs)


def test_download_on_cpu_is_the_same_memory():
    gen = tgenerator.Generator3D(None)
    grids = torch.arange(24, dtype=torch.float32).reshape(3, 2, 2, 2)
    host = gen.start_download(grids).wait()
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, grids.numpy())


# ------------------------------------------------------------ mesh files
def _sphere_mesh(module):
    verts, tris = tnative.marching_cubes(GRIDS["sphere"], 0.0)
    return module.TriMesh(verts / (R - 1) - 0.5, tris)


@pytest.mark.parametrize("ext", ["ply", "off"])
def test_mesh_export_and_load_match_jax(tmp_path, ext):
    got_path = str(tmp_path / f"port.{ext}")
    want_path = str(tmp_path / f"jax.{ext}")
    _sphere_mesh(tmesh).export(got_path)
    _sphere_mesh(jmesh).export(want_path)
    assert open(got_path, "rb").read() == open(want_path, "rb").read()
    for path in (got_path, want_path):
        got, want = tmesh.TriMesh.load(path), jmesh.TriMesh.load(path)
        assert_meshes_identical([got], [want])
        assert len(got.faces) == len(_sphere_mesh(tmesh).faces)
    # PLY stores float32, OFF prints float64 in full
    back = tmesh.TriMesh.load(got_path).vertices
    np.testing.assert_allclose(back, _sphere_mesh(tmesh).vertices,
                               atol=1e-7 if ext == "ply" else 0, rtol=0)


def test_ply_with_normals_and_ascii_match_jax(tmp_path):
    mesh = _sphere_mesh(tmesh)
    normals = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1,
                                             keepdims=True)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    tmesh.write_ply(a, mesh.vertices, mesh.faces, normals)
    jmesh.write_ply(b, mesh.vertices, mesh.faces, normals)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, want in zip(tmesh.read_ply(a), jmesh.read_ply(a)):
        assert_identical(got, want)
    ascii_path = str(tmp_path / "c.ply")
    with open(ascii_path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                "property float y\nproperty float z\nelement face 1\n"
                "property list uchar int vertex_indices\nend_header\n"
                "0 0 0\n1 0 0.5\n0 1 0\n3 0 1 2\n")
    for got, want in zip(tmesh.read_ply(ascii_path),
                         jmesh.read_ply(ascii_path)):
        assert_identical(got, want)


def test_off_polygons_and_glued_header_match_jax(tmp_path):
    path = str(tmp_path / "quad.off")
    with open(path, "w") as f:
        f.write("OFF4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    for got, want in zip(tmesh.read_off(path), jmesh.read_off(path)):
        assert_identical(got, want)
    assert tmesh.read_off(path)[1].tolist() == [[0, 1, 2], [0, 2, 3]]


def test_trimesh_methods_match_jax():
    got, want = _sphere_mesh(tmesh), _sphere_mesh(jmesh)
    assert_identical(got.bounds, want.bounds)
    assert_identical(tmesh.TriMesh(np.zeros((0, 3)), np.zeros((0, 3))).bounds,
                     np.zeros((2, 3)))
    m = np.eye(4)
    m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 2]]
    m[:3, 3] = [0.5, -1, 3]
    copy = got.copy()
    assert copy.apply_transform(m) is copy
    assert_identical(copy.vertices, want.copy().apply_transform(m).vertices)
    assert_identical(got.vertices, want.vertices)  # the copy moved, not got
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tmesh.TriMesh.load("scan.obj")
    with pytest.raises(ValueError, match="unsupported mesh format"):
        got.export("mesh.stl")


# ------------------------------------------------- boxes and placement
def _corner_boxes(n, seed):
    rng = np.random.RandomState(seed)
    return [jbox.get_3d_box(rng.uniform(0.3, 2.0, 3), rng.uniform(-3, 3),
                            rng.uniform(-2, 2, 3)) for _ in range(n)]


def test_box_util_matches_jax():
    rng = np.random.RandomState(2)
    boxes = _corner_boxes(6, 2)
    for size, angle, center in zip(rng.uniform(0.3, 2, (4, 3)),
                                   rng.uniform(-3, 3, 4),
                                   rng.uniform(-2, 2, (4, 3))):
        np.testing.assert_allclose(
            tbox.get_3d_box(size, angle, center),
            jbox.get_3d_box(size, angle, center), atol=1e-12, rtol=0)
    for a in boxes[:3]:
        near = a + rng.uniform(-0.2, 0.2, 3)
        for b in boxes + [near, a]:
            np.testing.assert_allclose(tbox.box3d_iou(a, b),
                                       jbox.box3d_iou(a, b), atol=1e-12,
                                       rtol=0)
            assert tbox.get_iou_obb(a, b) == tbox.box3d_iou(a, b)[0]
        np.testing.assert_allclose(tbox.box3d_vol(a), jbox.box3d_vol(a),
                                   atol=1e-12, rtol=0)
    assert tbox.box3d_iou(boxes[0], boxes[0] + [0.1, 0, 0.1])[0] > 0
    six = rng.uniform(0.5, 1.5, (5, 6))
    for a in six:
        for b in six:
            np.testing.assert_allclose(tbox.calc_iou(a, b),
                                       jbox.calc_iou(a, b), atol=1e-12,
                                       rtol=0)
    pts = rng.randn(4, 7, 3)
    for name in ("flip_axis_to_camera", "flip_axis_to_depth"):
        np.testing.assert_allclose(getattr(tbox, name)(pts),
                                   getattr(jbox, name)(pts), atol=1e-12,
                                   rtol=0)
    sq = [(0, 0), (2, 0), (2, 2), (0, 2)]
    tri = [(1, 1), (3, 1), (1, 3)]
    np.testing.assert_allclose(tbox.polygon_clip(tri, sq),
                               jbox.polygon_clip(tri, sq), atol=1e-12, rtol=0)
    assert tbox.polygon_clip([(5, 5), (6, 5), (6, 6)], sq) is None
    np.testing.assert_allclose(
        tbox.poly_area(np.array([0, 2, 2, 0.0]), np.array([0, 0, 2, 2.0])),
        4.0, atol=1e-12)


def test_box_params_and_placement_match_jax():
    assert_identical(trefit.TRANSFORM_SHAPENET, jrefit.TRANSFORM_SHAPENET)
    mesh_t, mesh_j = _sphere_mesh(tmesh), _sphere_mesh(jmesh)
    for corners in _corner_boxes(5, 3):
        np.testing.assert_allclose(
            trefit._box_params_from_corners(corners),
            jrefit._box_params_from_corners(corners), atol=1e-12, rtol=0)
        got = ttester.place_mesh_in_box(mesh_t, corners)
        want = jtester.place_mesh_in_box(mesh_j, corners)
        np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-12,
                                   rtol=0)
        np.testing.assert_array_equal(got.faces, want.faces)
        # the placed mesh fills its box: extents equal the box's sizes
        params = trefit._box_params_from_corners(corners)
        depth = tbox.flip_axis_to_depth(corners)
        assert np.all(got.vertices.min(0) >= depth.min(0) - 1e-9)
        assert np.all(got.vertices.max(0) <= depth.max(0) + 1e-9)
        assert params.shape == (7,)
    empty = tmesh.TriMesh(np.zeros((0, 3)), np.zeros((0, 3)))
    placed = ttester.place_mesh_in_box(empty, _corner_boxes(1, 4)[0])
    assert placed.vertices.shape == (0, 3) and placed is not empty


# ------------------------------------------------------- the build helper
def test_host_library_name_carries_source_flags_and_host(monkeypatch):
    path = _native.lib_path("meshing")
    assert path.parent == _native.BUILD_DIR
    assert path == _native.lib_path("meshing")
    assert "-march=native" in _native.GXX_FLAGS
    monkeypatch.setattr(_native, "GXX_FLAGS", _native.GXX_FLAGS + ("-g",))
    flagged = _native.lib_path("meshing")
    assert flagged != path
    monkeypatch.setattr(_native, "host_tag", lambda: "another-cpu")
    assert _native.lib_path("meshing") not in (path, flagged)
    # the kernels' names do not depend on the host's CPU
    monkeypatch.undo()
    fps = _native.lib_path("fps")
    monkeypatch.setattr(_native, "host_tag", lambda: "another-cpu")
    assert _native.lib_path("fps") == fps


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        _native.build(("meshing",))
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(ValueError, match="no native library"):
        _native.build(("nonesuch",))


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "meshing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "CSRC", src)
    monkeypatch.setattr(_native, "BUILD_DIR", src / "build")
    with pytest.raises(RuntimeError, match="the build failed for meshing"):
        _native.build(("meshing",))
    assert os.listdir(src / "build") == []
