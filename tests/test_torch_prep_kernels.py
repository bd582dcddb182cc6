"""The offline preparation's kernels' plain versions and host libraries of
the port (`rfdnet_tpu_torch.ops.fusion`, `.meshing.native`) against the
JAX package's host library (`rfdnet_tpu.meshing.native`), on the CPU.

Meshes: the sphere of `tests/test_prep.py` (marching tetrahedra of a
33^3 distance grid), one of the upstream demo's meshes
(`demo/outputs/scene0549_00/proposal_107_mesh.ply`) and the seeded
non-watertight mesh of `chip_smoke.open_mesh` (open boxes, a sphere
without its cap). Views from the ShapeNet tool's Fibonacci sphere.

Tolerances:
- `render_depth` (8 views of 96 x 96): the pixels whose coverage differs
  at most 1e-4 of all, and the depths where both cover within 1e-6. The
  port does every double operation separately rounded; the host library
  is built by g++, which may contract a product and a sum into one FMA,
  so a barycentric weight can differ in its last bit and flip a pixel
  whose weight is 0 to rounding;
- `tsdf_fuse` (the same views fused at 32^3): at most 1e-4 of the voxels
  differ by over 1e-6 (a projection index that flips the same way);
- `points_in_mesh`, `KDTree` (k = 1 and 4) and `kdtree_chamfer`: bit
  equal (copies of one source, the same flags).
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import open_mesh
from rfdnet_tpu.meshing import native as jnative
from rfdnet_tpu_torch.meshing import native as tnative
from rfdnet_tpu_torch.meshing.mesh import TriMesh
from rfdnet_tpu_torch.ops import fusion
from tools.prep.shapenet import fibonacci_views, look_at_pose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = HEIGHT = 96
FOCAL = 96.0
VIEWS = 8
RES = 32
FLIP_SHARE = 1e-4


def _sphere():
    n = 33
    ax = np.arange(n) / (n - 1) - 0.5
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    grid = (0.35 - np.linalg.norm(g, axis=-1)).astype(np.float32)
    v, t = jnative.marching_tetrahedra(grid, 0.0)
    return v / (n - 1) - 0.5, t


def _demo_mesh():
    m = TriMesh.load(os.path.join(ROOT, "demo", "outputs", "scene0549_00",
                                  "proposal_107_mesh.ply"))
    v = m.vertices
    center = (v.max(0) + v.min(0)) / 2
    return (v - center) / ((v.max(0) - v.min(0)).max() / 0.9), m.faces


def _open():
    v, t = open_mesh(seed=0)
    center = (v.max(0) + v.min(0)) / 2
    return (v - center) / ((v.max(0) - v.min(0)).max() / 0.9), t


MESHES = {"sphere": _sphere, "demo": _demo_mesh, "open": _open}


def _poses(views=VIEWS):
    return np.stack([look_at_pose(e) for e in fibonacci_views(views) * 2.0])


def _jax_depths(v, t, poses):
    return np.stack([jnative.render_depth(v, t, p, FOCAL, WIDTH / 2,
                                          HEIGHT / 2, WIDTH, HEIGHT)
                     for p in poses])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_render_and_fuse_plain_match_host(name):
    v, t = MESHES[name]()
    poses = _poses()
    want = _jax_depths(v, t, poses)
    got = fusion.render_depth(torch.from_numpy(v), torch.from_numpy(
        np.ascontiguousarray(t, np.int32)), torch.from_numpy(poses), FOCAL,
        WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    differs = int(((got > 0) != (want > 0)).sum())
    both = (got > 0) & (want > 0)
    err = float(np.abs(got - want)[both].max())
    print(f"{name}: coverage differs on {differs} of {got.size} pixels, "
          f"covered {float((got > 0).mean()):.3f}, depth error {err}")
    assert (got > 0).any()
    assert differs <= FLIP_SHARE * got.size
    assert err <= 1e-6

    bbox = np.array([-0.5, -0.5, -0.5, 0.5, 0.5, 0.5])
    trunc = 10.0 / RES
    want_t = jnative.tsdf_fuse(want, poses, FOCAL, WIDTH / 2, HEIGHT / 2,
                               RES, bbox, trunc)
    got_t = fusion.tsdf_fuse(torch.from_numpy(want), torch.from_numpy(poses),
                             FOCAL, WIDTH / 2, HEIGHT / 2, RES, bbox,
                             trunc).numpy()
    over = int((np.abs(got_t - want_t) > 1e-6).sum())
    print(f"{name}: {over} of {got_t.size} voxels differ by over 1e-6")
    assert got_t.shape == (RES,) * 3 and got_t.dtype == np.float32
    assert (got_t < 0).any() and (got_t == 1).any()
    assert over <= FLIP_SHARE * got_t.size


def test_render_one_pose_is_the_host_call():
    """A (4, 4) pose gives one (H, W) map, the JAX package's call, equal to
    that view of a batched call. From inside the sphere, looking down an
    axis, pixel centres fall on shared edges: where the host's FMA makes
    both triangles' weights slightly negative it leaves a pinhole, which
    the port covers; every pixel that differs must be such a pinhole
    (covered here, not on the host, its four neighbours covered there)."""
    v, t = _sphere()
    eyes = np.array([[0.0, 0.0, -2.0], [0.0, 0.0, -0.2]])
    poses = np.stack([look_at_pose(e) for e in eyes])
    batch = fusion.render_depth(torch.from_numpy(v), torch.from_numpy(t),
                                torch.from_numpy(poses), FOCAL, WIDTH / 2,
                                HEIGHT / 2, WIDTH, HEIGHT).numpy()
    for i, pose in enumerate(poses):
        want = jnative.render_depth(v, t, pose, FOCAL, WIDTH / 2, HEIGHT / 2,
                                    WIDTH, HEIGHT)
        got = fusion.render_depth(torch.from_numpy(v), torch.from_numpy(t),
                                  torch.from_numpy(pose), FOCAL, WIDTH / 2,
                                  HEIGHT / 2, WIDTH, HEIGHT).numpy()
        assert got.shape == (HEIGHT, WIDTH)
        np.testing.assert_array_equal(got, batch[i])
        differ = np.argwhere((got > 0) != (want > 0))
        print(f"view {i}: coverage differs at {differ.tolist()}")
        for y, x in differ:
            assert got[y, x] > 0 and want[y, x] == 0
            assert all(want[y + dy, x + dx] > 0 for dy, dx in (
                (-1, 0), (1, 0), (0, -1), (0, 1)))


def test_plain_work_counts():
    """The plain versions' counts of their work (what `chip_smoke.py`'s
    bounds read) agree with the outputs they describe."""
    v, t = _sphere()
    poses = _poses(4)
    work = {}
    depth = fusion.render_depth_plain(
        torch.from_numpy(v), torch.from_numpy(t), torch.from_numpy(poses),
        FOCAL, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT, work=work)
    assert work["items"] == 4 * len(t)
    assert 0 < work["drawn"] <= work["items"]
    # every covered pixel is covered by at least one triangle
    assert work["covered"] >= int((depth > 0).sum())
    assert work["box_pixels"] >= work["covered"]
    twork = {}
    fusion.tsdf_fuse_plain(depth, torch.from_numpy(poses), FOCAL, WIDTH / 2,
                           HEIGHT / 2, 16, (-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
                           0.5, work=twork)
    assert twork["voxel_views"] == 4 * 16 ** 3
    assert (twork["voxel_views"] >= twork["in_front"] >= twork["sampled"]
            >= twork["averaged"] > 0)


def test_wrappers_reject_bad_shapes():
    v, t = _sphere()
    with pytest.raises(ValueError, match="poses shape"):
        fusion.render_depth(torch.from_numpy(v), torch.from_numpy(t),
                            torch.zeros(3, 4), FOCAL, 48, 48, 96, 96)


def test_points_in_mesh_bit_equal():
    rng = np.random.RandomState(0)
    for v, t in (_sphere(), _demo_mesh()):
        # uniform points and points near the surface (off lattice), and a
        # few exactly on vertices
        pts = np.concatenate([rng.uniform(-0.55, 0.55, (20000, 3)),
                              v[rng.randint(0, len(v), 5000)]
                              + 1e-3 * rng.randn(5000, 3),
                              v[:100]])
        got = tnative.points_in_mesh(v, t, pts)
        want = jnative.points_in_mesh(v, t, pts)
        assert got.dtype == bool and 0.05 < got.mean() < 0.95
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 4])
def test_kdtree_bit_equal(k):
    rng = np.random.RandomState(k)
    pts = rng.rand(20000, 3)
    q = np.concatenate([rng.rand(5000, 3), pts[:50]])  # and exact hits
    got_d, got_i = tnative.KDTree(pts).query(q, k)
    want_d, want_i = jnative.KDTree(pts).query(q, k)
    assert got_d.shape == ((len(q),) if k == 1 else (len(q), k))
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)
    # nearest first, and the exact hits find themselves at distance 0
    if k > 1:
        assert (np.diff(got_d, axis=1) >= 0).all()
    first = got_i if k == 1 else got_i[:, 0]
    np.testing.assert_array_equal(first[-50:], np.arange(50))


def test_kdtree_more_neighbours_than_points():
    pts = np.random.RandomState(2).rand(3, 3)
    got = tnative.KDTree(pts).query(pts[:1], 5)
    want = jnative.KDTree(pts).query(pts[:1], 5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][0, 3:] == -1).all()


def test_kdtree_chamfer_bit_equal():
    rng = np.random.RandomState(3)
    a, b = rng.rand(4000, 3), rng.rand(3000, 3) + 0.1
    got = tnative.kdtree_chamfer(a, b)
    assert got == jnative.kdtree_chamfer(a, b)
    assert tnative.kdtree_chamfer(a, a) == 0.0
