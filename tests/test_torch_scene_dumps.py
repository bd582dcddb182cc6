"""The scene dumps of the port against `rfdnet_tpu`'s, on the CPU: the
Tester's per-scene files with `scene.html`, the scene helpers
(`utils/scene_viz.py`), the WebGL and PLY exports, and the camera of the
numpy `pred.png` renderer against matplotlib's projection.

Tolerances:
- files: bytes identical (the JAX Tester's `visualize_step` and the
  port's on the same scene outputs; `export_html` / `export_ply` of the
  same `SceneRender`);
- float64 helpers: atol 1e-12;
- the renderer's camera: within 1e-6 pixels of matplotlib's projection and
  transform of the same points in the figure `rfdnet_tpu.demo.visualize`
  draws.
"""

import os
import types

import numpy as np
import pytest

from rfdnet_tpu.eval import tester as jtester
from rfdnet_tpu.meshing.mesh import TriMesh as JTriMesh
from rfdnet_tpu.utils import scene_viz as jviz
from rfdnet_tpu_torch.eval import tester as ttester
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from rfdnet_tpu_torch.utils import render
from rfdnet_tpu_torch.utils import scene_viz as tviz
from test_torch_meshing import GRIDS
from rfdnet_tpu_torch.meshing import native as tnative


def _scene(seed=0, proposals=6, slots=4):
    """Scene outputs as the Tester's `consume_step` returns them: a scan,
    NMS'd proposals with boxes, valid slots with meshes (one empty), the
    pred / gt lists."""
    rng = np.random.RandomState(seed)
    pc = rng.uniform(-2, 2, (1, 500, 4)).astype(np.float32)
    centers = rng.uniform(-1.5, 1.5, (proposals, 3))
    sizes = rng.uniform(0.3, 1.0, (proposals, 3))
    heading = rng.uniform(-np.pi, np.pi, proposals)
    corners = np.stack([jviz._corners(c, jviz.box7_to_vectors(
        np.r_[c, s, a])[1]) for c, s, a in zip(centers, sizes, heading)])
    # camera frame, as `pred_corners_3d_upright_camera`
    corners = corners[..., [0, 2, 1]] * np.array([1, -1, 1])
    parsed = {
        "pred_mask": np.array([[1, 1, 0, 1, 1, 1]], bool),
        "obj_prob": rng.uniform(0.3, 1.0, (1, proposals)),
        "pred_corners_3d_upright_camera": corners[None],
        "pred_sem_cls": rng.randint(0, 8, (1, proposals)),
    }
    ids = np.array([[[0, 0, 1], [3, 1, 2], [4, 2, 0], [5, 0, 5]]])
    gen = {"proposal_ids": ids, "valid": np.array([[True, True, False,
                                                    True]])}
    v, f = tnative.marching_cubes(np.pad(GRIDS["sphere"], 1,
                                         constant_values=-1e6), 0.0)
    meshes = [TriMesh(v / 13 - 0.5, f), TriMesh(np.zeros((0, 3)),
                                                np.zeros((0, 3))),
              TriMesh(v / 13 - 0.5, f), TriMesh(v / 20, f)]
    out = {"parsed": parsed, "gen": gen, "meshes": meshes,
           "batch_pred_map_cls": [[(1, corners[0], 0.9)]],
           "batch_gt_map_cls": [[(2, corners[1])]]}
    return out, {"point_clouds": pc}


def _read(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


@pytest.mark.parametrize("seed", [0, 1])
def test_tester_dumps_match_jax(tmp_path, seed):
    """The port's `Tester.visualize_step` writes the JAX Tester's files,
    `scene.html` included, byte for byte, and logs no failure."""
    out, batch = _scene(seed)
    logged = []
    conf = {"conf_thresh": 0.5}
    port = types.SimpleNamespace(eval_config=conf, log=logged.append)
    ttester.Tester.visualize_step(port, out, batch,
                                  str(tmp_path / "port" / "scene_00000"))
    jout = dict(out, meshes=[JTriMesh(m.vertices, m.faces)
                             for m in out["meshes"]])
    jax_self = types.SimpleNamespace(
        cfg=types.SimpleNamespace(eval_config=conf), log=logged.append)
    jtester.Tester.visualize_step(jax_self, jout, batch,
                                  str(tmp_path / "jax" / "scene_00000"))
    got = _read(tmp_path / "port" / "scene_00000")
    want = _read(tmp_path / "jax" / "scene_00000")
    assert logged == []
    assert "scene.html" in got and len(got) >= 6
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name] == want[name], name


def test_tester_dump_failure_is_logged(tmp_path):
    out, batch = _scene()
    out["parsed"]["pred_sem_cls"] = None   # the HTML export fails on it
    logged = []
    port = types.SimpleNamespace(eval_config={"conf_thresh": 0.5},
                                 log=logged.append)
    ttester.Tester.visualize_step(port, out, batch, str(tmp_path))
    assert len(logged) == 1 and "scene.html export failed" in logged[0]
    assert "pred_map_cls.txt" in os.listdir(tmp_path)


def test_scene_helpers_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(5):
        box7 = np.r_[rng.randn(3), rng.uniform(0.2, 2, 3), rng.randn()]
        for got, want in zip(tviz.box7_to_vectors(box7),
                             jviz.box7_to_vectors(box7)):
            np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        v = rng.uniform(-0.5, 0.5, (20, 3))
        np.testing.assert_allclose(
            tviz.place_canonical_mesh_in_box7(v, box7),
            jviz.place_canonical_mesh_in_box7(v, box7), atol=1e-12, rtol=0)
        corners = jviz._corners(*jviz.box7_to_vectors(box7))
        np.testing.assert_allclose(tviz._corners(*tviz.box7_to_vectors(box7)),
                                   corners, atol=1e-12, rtol=0)
        for got, want in zip(tviz.corners_to_center_vectors(corners),
                             jviz.corners_to_center_vectors(corners)):
            np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    for n in (8, 10, 3):
        np.testing.assert_allclose(tviz.hls_palette(n), jviz.hls_palette(n),
                                   atol=1e-12, rtol=0)
    assert tviz._BOX_FACES == jviz._BOX_FACES


@pytest.mark.parametrize("mode", ["class", "instance"])
def test_scene_exports_match_jax(tmp_path, mode):
    out, batch = _scene(3)
    meshes = [(m.vertices * 2 + 1, m.faces) for m in out["meshes"]]
    rng = np.random.RandomState(4)
    boxes = [jviz.box7_to_vectors(np.r_[rng.randn(3), rng.uniform(0.2, 2, 3),
                                        rng.randn()]) for _ in meshes]
    kw = dict(meshes=meshes, centers=[b[0] for b in boxes],
              vectors=[b[1] for b in boxes], class_ids=[3, 1, 7, 12])
    pts = batch["point_clouds"][0]
    got, want = tviz.SceneRender(pts, **kw), jviz.SceneRender(pts, **kw)
    for name, call in (("a.html", lambda r, p: r.export_html(
            p, title="t", class_names=["x", "y"], color_mode=mode,
            max_points=300)),
                       ("a.ply", lambda r, p: r.export_ply(
            p, color_mode=mode, max_points=300))):
        os.makedirs(tmp_path / "p", exist_ok=True)
        os.makedirs(tmp_path / "j", exist_ok=True)
        call(got, str(tmp_path / "p" / name))
        call(want, str(tmp_path / "j" / name))
        assert (open(tmp_path / "p" / name, "rb").read()
                == open(tmp_path / "j" / name, "rb").read()), name


def test_render_camera_matches_matplotlib():
    """The renderer's projection of points in the figure JAX's
    `demo.visualize` draws (10 x 8 in, 120 dpi, elev 55, azim -60, box
    aspect from the scan, tight layout) lands where matplotlib puts them."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(0)
    pc = rng.uniform(0, 1, (800, 3)) * np.array([5.0, 4.0, 2.5]) - 1.0
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.3)
    ax.view_init(elev=55, azim=-60)
    ax.set_axis_off()
    ax.set_box_aspect(pc.max(0) - pc.min(0))
    plt.tight_layout()
    fig.set_dpi(120)
    fig.canvas.draw()
    from mpl_toolkits.mplot3d import proj3d

    xs, ys, _ = proj3d.proj_transform(pc[:, 0], pc[:, 1], pc[:, 2], ax.M)
    want = ax.transData.transform(np.stack([xs, ys], 1))
    plt.close(fig)
    lims = np.stack([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    lo, hi = pc.min(0), pc.max(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * 55 / 48
    np.testing.assert_allclose(lims, np.stack([mid - half, mid + half], 1),
                               atol=1e-9)
    col, row, _ = render.Camera(lims, pc.max(0) - pc.min(0))(pc)
    np.testing.assert_allclose(col, want[:, 0], atol=1e-6)
    np.testing.assert_allclose(render.HEIGHT - row, want[:, 1], atol=1e-6)


def test_render_scene_draws_every_part(tmp_path):
    out, batch = _scene()
    pts = batch["point_clouds"][0, :, :3]
    empty = render.render_scene(pts)
    boxes = [jviz._corners(*jviz.box7_to_vectors(np.r_[0, 0, 0, 1, 1, 1, 0]))]
    v, f = out["meshes"][0].vertices, out["meshes"][0].faces
    full = render.render_scene(pts, boxes, [(v, f)], [render.TAB20[2]])
    assert empty.shape == full.shape == (960, 1200, 3)
    assert (empty < 250).any(-1).sum() > 100
    assert (full != empty).any(-1).sum() > 1000
    path = render.write_scene_png(str(tmp_path / "x.png"), pts, boxes,
                                  [(v, f)], [render.TAB20[2]])
    import matplotlib.image

    np.testing.assert_array_equal(
        (matplotlib.image.imread(path)[..., :3] * 255).round(), full)
