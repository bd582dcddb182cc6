"""The port's data and evaluation modules against `rfdnet_tpu`'s, on the
CPU: synthetic scenes, binvox files, the dataset item and `collate` from
an on-disk scene, the dataset constants, the chamfer search, the box refit
(`_optimize` and `fit_meshes_to_scan`), VOC AP and its assembly, and the
box dump.

Tolerances:
- arrays of the data path, index outputs, AP metrics and dump bytes are
  exact;
- chamfer distances: f32 `atol 3e-5, rtol 2e-4`, nearest indices equal
  wherever the best candidate leads the second by more than 1e-5 in
  squared distance (the two packages sum the quadratic form in another
  order);
- `_optimize` (60 and 100 Adam steps on the two well-conditioned cases of
  `tests/test_pipeline.py`): centroids and headings within 1e-4, the
  best-loss step's parameters, so the strict `<` has to agree as well;
- `fit_meshes_to_scan` on equal meshes and a jittered scene: corners
  within 1e-3 (30 steps; the packages agree to 4e-6 for 20 steps, then a
  chamfer match that flips on a near-tie moves one box by 1.2e-4).
"""

import importlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.config.scannet import ScannetConfig
from rfdnet_tpu.data import binvox as jbinvox
from rfdnet_tpu.data import scannet as jscannet
from rfdnet_tpu.data.synthetic import synthetic_scene_batch as jsynthetic
from rfdnet_tpu.eval import ap_helper as jap
from rfdnet_tpu.eval import refit as jrefit
from rfdnet_tpu.eval.tester import compute_iou as jcompute_iou
from rfdnet_tpu.meshing.mesh import TriMesh as JTriMesh
from rfdnet_tpu.ops.chamfer import chamfer_distance as jchamfer
from rfdnet_tpu.utils.visualization import write_oriented_bbox_ply as jwrite_bbox
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data import binvox, scannet, synthetic
from rfdnet_tpu_torch.eval import ap_helper, eval_det, refit
from rfdnet_tpu_torch.eval.box_util import flip_axis_to_depth
from rfdnet_tpu_torch.eval.tester import compute_iou
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from rfdnet_tpu_torch.ops import chamfer
from rfdnet_tpu_torch.utils.visualization import write_oriented_bbox_ply
from torch_parity import assert_close, assert_equal, t

# the module (the package exports a function of the same name)
jeval_det = importlib.import_module("rfdnet_tpu.eval.eval_det")


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kw", [
    dict(batch_size=2, num_points=4096),
    dict(batch_size=1, num_points=5000, num_objects=7, num_obj_points=2048,
         mean_size_arr=tconfig.MEAN_SIZE_ARR),
])
def test_synthetic_scene_batch_matches_jax(kw):
    got = synthetic.synthetic_scene_batch(np.random.RandomState(3), **kw)
    want = jsynthetic(np.random.RandomState(3), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert_equal(got[k], want[k], what=k)


def test_dataset_constants_match_scannet_config():
    dc = ScannetConfig()
    assert tconfig.CLASS2TYPE == dc.class2type
    assert tconfig.TYPE2CLASS == dc.type2class
    assert tconfig.SHAPENETID2CLASS == dc.shapenetid2class
    assert list(tconfig.CLASS_IDS) == list(dc.class_ids)
    angles = np.random.RandomState(0).uniform(-7, 7, 50)
    for got, want in zip(tconfig.angle2class(angles), dc.angle2class(angles)):
        assert got.dtype == want.dtype
        assert_equal(got, want)


def test_binvox_round_trip_matches_jax():
    data = np.random.RandomState(0).rand(16, 12, 9) > 0.6
    ours, theirs = io.BytesIO(), io.BytesIO()
    binvox.write_binvox(ours, binvox.Voxels(data, data.shape, [-0.5] * 3, 1.0))
    jbinvox.write_binvox(theirs, jbinvox.Voxels(data, data.shape, [-0.5] * 3,
                                                1.0))
    assert ours.getvalue() == theirs.getvalue()
    got = binvox.read_binvox(io.BytesIO(theirs.getvalue()))
    want = jbinvox.read_binvox(io.BytesIO(ours.getvalue()))
    assert_equal(got.data, data)
    assert_equal(want.data, data)
    assert (got.dims, got.translate, got.scale) == (
        want.dims, want.translate, want.scale)


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    return synthetic.write_scannet_scenes(
        str(tmp_path_factory.mktemp("scannet")), 3, seed=4, num_points=3000,
        num_objects=5)


def _datasets(on_disk, mode, phase, **kw):
    split = os.path.join(on_disk["split"], "scannetv2_val.json")
    common = dict(mode=mode, phase=phase, num_points=2048,
                  shapenet_path=on_disk["shapenet_path"], seed=7, **kw)
    return (scannet.ScanNetDataset(split, **common),
            jscannet.ScanNetDataset(split, **common))


@pytest.mark.parametrize("mode, phase", [("test", "completion"),
                                         ("train", "completion"),
                                         ("test", "detection")])
def test_dataset_item_and_collate_match_jax(on_disk, mode, phase):
    ours, theirs = _datasets(on_disk, mode, phase, cache_scans=2)
    assert len(ours) == len(theirs) == 3
    items, want_items = [ours[i] for i in range(3)], [theirs[i] for i in
                                                      range(3)]
    for got, want in zip(items, want_items):
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], list):
                assert got[k] == want[k], k
            else:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
                assert_equal(got[k], want[k], what=k)
    if phase == "completion":
        # the writer's objects: 1024 free then 1024 occupied points each
        occ = items[0]["object_points_occ"]
        n = int(items[0]["box_label_mask"].sum())
        assert n == 5 and (occ[:n, :1024] == 0).all()
        assert (occ[:n, 1024:] == 1).all()
    got, want = scannet.collate(items[:2]), jscannet.collate(want_items[:2])
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert_equal(got[k], want[k], what=k)
    again = ours[0]  # cached scan: the same item
    assert_equal(again["point_clouds"], items[0]["point_clouds"])


def test_loader_batches_match_jax_and_raise_failures(on_disk):
    ours, theirs = _datasets(on_disk, "test", "completion")
    got = list(scannet.DataLoader(ours, batch_size=2, num_workers=2))
    want = list(jscannet.DataLoader(theirs, batch_size=2, num_workers=1))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_equal(a["point_clouds"], b["point_clouds"])
        assert_equal(a["object_points"], b["object_points"])
        assert a["shapenet_ids"] == b["shapenet_ids"]
    ours.split = ours.split + [{"scan": "missing.npz", "bbox": "missing.pkl"}]
    with pytest.raises(FileNotFoundError):
        list(scannet.DataLoader(ours, batch_size=2, num_workers=2))


# --------------------------------------------------------------- chamfer
def test_chamfer_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(2, 700, 3).astype(np.float32)
    b = rng.randn(2, 2600, 3).astype(np.float32)  # > the JAX chunk of 2048
    want = [np.asarray(d) for d in jchamfer(jnp.asarray(a), jnp.asarray(b))]
    got = chamfer.chamfer_distance(t(a), t(b))
    for g, w in zip(got, want):
        assert_close(g, w)
    # blocks of a few rows each: the search must not depend on the block
    for queries, cands in ((a, b), (b, a)):
        full = ((queries[:, :, None] - cands[:, None]) ** 2).sum(-1)
        srt = np.sort(full, axis=-1)
        clear = srt[..., 1] - srt[..., 0] > 1e-5
        want_idx = full.argmin(-1)
        for block in (1 << 26, 3 * cands.shape[1] * 2):
            idx = chamfer.nearest_neighbour(t(queries), t(cands),
                                            max_block_elems=block).numpy()
            assert_equal(idx[clear], want_idx[clear])
            assert clear.mean() > 0.99


def test_chamfer_gradient_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(1, 40, 3).astype(np.float32)
    b = rng.randn(1, 30, 3).astype(np.float32)

    def jloss(av, bv):
        d1, d2 = jchamfer(av, bv)
        return jnp.mean(d1) + 2.0 * jnp.mean(d2)

    want = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))]
    at, bt = t(a).requires_grad_(True), t(b).requires_grad_(True)
    d1, d2 = chamfer.chamfer_distance(at, bt)
    (d1.mean() + 2.0 * d2.mean()).backward()
    assert_close(at.grad, want[0])
    assert_close(bt.grad, want[1])


# ----------------------------------------------------------------- refit
def _translation_case():
    rng = np.random.RandomState(0)
    pc = rng.uniform(-0.5, 0.5, size=(1, 400, 3)).astype(np.float32)
    obj = rng.uniform(-0.5, 0.5, size=(1, 200, 3)).astype(np.float32)
    start = np.array([[0.4, -0.3, 0.2]], np.float32)
    return (obj, pc, np.ones((1, 400), np.float32), start,
            np.zeros((1,), np.float32), np.float32(400)), 60


def _heading_case():
    rng = np.random.RandomState(1)
    obj = rng.uniform(-0.5, 0.5, size=(1, 300, 3)).astype(np.float32)
    obj[..., 0] *= 2.0
    c, s = np.cos(0.35), np.sin(0.35)
    R = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    scene = (obj[0] @ R)[None]
    return (obj, scene, np.ones((1, 300), np.float32),
            np.zeros((1, 3), np.float32), np.zeros((1,), np.float32),
            np.float32(300)), 100


@pytest.mark.parametrize("case", [_translation_case, _heading_case],
                         ids=["translation", "heading"])
def test_optimize_matches_jax(case):
    args, iterations = case()
    want = [np.asarray(x) for x in jrefit._optimize(
        *(jnp.asarray(a) for a in args), iterations=iterations)]
    got = refit._optimize(*(torch.as_tensor(a) for a in args),
                          iterations=iterations)
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-4, rtol=0)
    if case is _heading_case:
        assert abs(float(got[1][0]) - 0.35) < 0.05


def _box_mesh(rng, n=300):
    """A closed-ish canonical mesh: points on a box surface, faces over
    them."""
    v = rng.uniform(-0.5, 0.5, size=(n, 3))
    v[np.arange(n), rng.randint(0, 3, n)] = rng.choice([-0.5, 0.5], n)
    f = rng.randint(0, n, size=(n, 3)).astype(np.int32)
    return v * np.array([0.9, 0.6, 0.7]), f


def test_fit_meshes_to_scan_matches_jax():
    """Two scenes, three slots each: confident boxes with meshes refit, an
    invalid slot, a mesh-less slot and one below the threshold left
    alone, on equal meshes and predictions."""
    rng = np.random.RandomState(2)
    B, K, G = 2, 6, 3
    centers = rng.uniform(-1.5, 1.5, size=(B, K, 3))
    sizes = rng.uniform(0.6, 1.2, size=(B, K, 3))
    headings = rng.uniform(-np.pi, np.pi, size=(B, K))
    corners = np.stack([np.stack([
        ap_helper.corners_from_params(sizes[i, j], -headings[i, j],
                                      centers[i, j])
        for j in range(K)]) for i in range(B)])
    # scene points on the boxes' faces (camera frame -> depth frame)
    pts = []
    for i in range(B):
        p = flip_axis_to_depth(corners[i].reshape(-1, 3))
        jitter = rng.normal(0, 0.05, size=(40,) + p.shape)
        pts.append((p[None] + jitter).reshape(-1, 3))
    n = min(len(p) for p in pts)
    point_clouds = np.stack([p[:n] for p in pts]).astype(np.float32)
    parsed = {
        "pred_corners_3d_upright_camera": corners,
        "pred_mask": np.ones((B, K), bool),
        "obj_prob": np.full((B, K), 0.9),
    }
    parsed["obj_prob"][1, 4] = 0.1
    proposal_ids = np.zeros((B, G, 3), np.int32)
    proposal_ids[:, :, 0] = [[0, 2, 3], [1, 4, 5]]
    valid = np.array([[True, True, False], [True, True, True]])
    meshes = []
    for i in range(B * G):
        v, f = _box_mesh(rng)
        meshes.append(TriMesh(v, f) if i != 5 else TriMesh(
            np.zeros((0, 3)), np.zeros((0, 3), np.int32)))
    jmeshes = [JTriMesh(m.vertices, m.faces) for m in meshes]
    want = jrefit.fit_meshes_to_scan(
        {k: v.copy() for k, v in parsed.items()}, jmeshes, proposal_ids,
        valid, point_clouds, 0.5, iterations=30)
    got = refit.fit_meshes_to_scan(
        {k: v.copy() for k, v in parsed.items()}, meshes, proposal_ids,
        valid, point_clouds, 0.5, iterations=30, device="cpu")
    c_got = got["pred_corners_3d_upright_camera"]
    c_want = want["pred_corners_3d_upright_camera"]
    assert_close(c_got, c_want, atol=1e-3, rtol=0)
    moved = np.abs(c_got - corners).max(axis=(2, 3)) > 1e-6
    # refit: (0,0) (0,2) (1,1); left alone: not selected, invalid slot
    # (0,3), below threshold (1,4), empty mesh (1,5)
    assert_equal(moved, [[1, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0]])


# -------------------------------------------------------------------- AP
def _pred_gt(seed, scans=4):
    """Per scan GT boxes of a few classes and predictions near some of them
    (jittered copies, some of the wrong class, some far off)."""
    rng = np.random.RandomState(seed)
    pred, gt = {}, {}
    for s in range(scans):
        boxes = []
        for _ in range(rng.randint(2, 6)):
            c = int(rng.randint(0, 4))
            boxes.append((c, ap_helper.corners_from_params(
                rng.uniform(0.5, 1.5, 3), rng.uniform(-np.pi, np.pi),
                rng.uniform(-3, 3, 3))))
        gt[s] = boxes
        preds = []
        for c, corners in boxes:
            for _ in range(rng.randint(0, 3)):
                cls = c if rng.rand() < 0.8 else int(rng.randint(0, 5))
                preds.append((cls, corners + rng.normal(0, 0.08, (1, 3)),
                              float(rng.rand())))
        preds.append((1, boxes[0][1] + 5.0, 0.95))
        pred[s] = preds
    return pred, gt


@pytest.mark.parametrize("use_07", [True, False])
def test_eval_det_matches_jax(use_07):
    pred, gt = _pred_gt(0)
    for thresh in (0.25, 0.5):
        got = eval_det.eval_det(pred, gt, ovthresh=thresh,
                                use_07_metric=use_07, parallel=False)
        want = jeval_det.eval_det(pred, gt, ovthresh=thresh,
                                  use_07_metric=use_07, parallel=False)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for c in w:
                assert_equal(g[c], w[c], what=str(c))
    assert any(v > 0 for v in got[2].values())


def test_ap_calculator_matches_jax():
    """Both packages' calculators fed scan by scan; the port's spawned pool
    and its serial path give the JAX metrics."""
    pred, gt = _pred_gt(1, scans=6)
    ours = ap_helper.APCalculator(0.25, tconfig.CLASS2TYPE)
    theirs = jap.APCalculator(0.25, tconfig.CLASS2TYPE)
    for s in pred:
        ours.step([pred[s]], [gt[s]])
        theirs.step([pred[s]], [gt[s]])
    want = theirs.compute_metrics(parallel=False)
    assert ours.compute_metrics(parallel=False) == want
    assert ours.compute_metrics(parallel=True) == want
    assert 0 < want["mAP"] < 1


def test_parse_groundtruths_and_assembly_match_jax():
    rng = np.random.RandomState(5)
    batch = synthetic.synthetic_scene_batch(
        rng, batch_size=2, num_points=512, num_objects=5,
        mean_size_arr=tconfig.MEAN_SIZE_ARR)
    dc = ScannetConfig()
    got = ap_helper.parse_groundtruths(batch)
    want = jap.parse_groundtruths(batch, dc)
    for k in want:
        assert_equal(got[k], want[k], what=k)
    a, b = ap_helper.assembly_gt_map_cls(got), jap.assembly_gt_map_cls(want)
    assert [len(x) for x in a] == [len(x) for x in b] == [5, 5]
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u[0] == v[0] and np.array_equal(u[1], v[1])
    K = 20
    corners = rng.normal(size=(2, K, 8, 3))
    sem = rng.dirichlet(np.ones(8), size=(2, K)).astype(np.float32)
    parsed = {
        "pred_corners_3d_upright_camera": corners,
        "sem_cls_probs": sem,
        "obj_prob": rng.rand(2, K).astype(np.float32),
        "pred_mask": rng.rand(2, K) > 0.3,
        "pred_sem_cls": sem.argmax(-1),
    }
    for per_class in (True, False):
        a = ap_helper.assembly_pred_map_cls(parsed, 0.2, per_class)
        b = jap.assembly_pred_map_cls(parsed, dc, 0.2, per_class)
        assert [len(x) for x in a] == [len(x) for x in b] and len(a[0]) > 0
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert u[0] == v[0] and u[2] == v[2]
                assert np.array_equal(u[1], v[1])


def test_write_oriented_bbox_ply_and_compute_iou_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    corners = np.stack([ap_helper.corners_from_params(
        rng.uniform(0.5, 1, 3), rng.uniform(-3, 3), rng.normal(size=3))
        for _ in range(3)])
    write_oriented_bbox_ply(str(tmp_path / "a.ply"), corners)
    jwrite_bbox(str(tmp_path / "b.ply"), corners)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    write_oriented_bbox_ply(str(tmp_path / "c.ply"), np.zeros((0, 8, 3)))
    jwrite_bbox(str(tmp_path / "d.ply"), np.zeros((0, 8, 3)))
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "d.ply").read_bytes()
    a = rng.rand(5, 16, 16, 16) > 0.5
    b = rng.rand(5, 16, 16, 16) > 0.3
    b[0] = False
    a[0] = False
    assert_equal(compute_iou(a, b), jcompute_iou(a, b))
