"""The port's geometry ops (`rfdnet_tpu_torch.ops`) against `rfdnet_tpu.ops`
on the CPU, same numpy inputs.

Tolerances: index outputs (FPS, grouping indices, three-NN indices, NMS
keep masks) are exact; ball query is exact except for points with
|d^2 - r^2| <= 1e-5 r^2 (both packages use the quadratic form
|c|^2 + |p|^2 - 2 c.p, whose rounding depends on the products' summation
order); gathers are bit-exact; float outputs use atol 3e-5, rtol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu import ops as jops
from rfdnet_tpu_torch import ops as tops
from rfdnet_tpu_torch.utils import profiling
from torch_parity import assert_close, assert_equal, t


def _cloud(seed, B, N, dup=False, near_origin=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    if dup:  # exact duplicates, as the demo's subsample with replacement
        xyz = xyz[:, rng.randint(0, N // 4, N)]
    if near_origin:
        xyz[:, 1:1 + near_origin] *= 1e-3
    return xyz


@pytest.mark.parametrize("dup,near_origin,npoint", [
    (False, 0, 300), (True, 0, 300), (False, 40, 300), (True, 40, 1400),
])
def test_fps_matches_jax(dup, near_origin, npoint):
    xyz = _cloud(0, 2, 1500, dup, near_origin)
    want = jops.furthest_point_sample(jnp.asarray(xyz), npoint, impl="xla")
    got = tops.furthest_point_sample(t(xyz), npoint)
    assert got.dtype == torch.int32
    assert_equal(got, want)


def test_fps_cpu_wrapper_takes_plain_and_counts_nothing():
    xyz = t(_cloud(1, 1, 300))
    with profiling.recording() as rec:
        assert_equal(tops.furthest_point_sample(xyz, 50),
                     tops.fps.fps_plain(xyz, 50))
    assert rec.counter("ops.fps.launches") == 0


@pytest.mark.parametrize("radius,nsample,M", [(0.2, 64, 256), (0.8, 16, 64),
                                              (1.0, 1024, 8)])
def test_ball_query_matches_jax_off_boundary(radius, nsample, M):
    rng = np.random.RandomState(2)
    xyz = rng.uniform(-1.5, 1.5, (2, 3000, 3)).astype(np.float32)
    centers = xyz[:, rng.choice(3000, M, replace=False)] + rng.normal(
        0, 0.01, (2, M, 3)).astype(np.float32)
    want = np.asarray(jops.ball_query(jnp.asarray(xyz), jnp.asarray(centers),
                                      radius, nsample))
    got = tops.ball_query(t(xyz), t(centers), radius, nsample).numpy()
    d2 = np.sum((centers[:, :, None].astype(np.float64)
                 - xyz[:, None].astype(np.float64)) ** 2, -1)
    ambiguous = (np.abs(d2 - radius ** 2) <= 1e-5 * radius ** 2).any(-1)
    assert ambiguous.mean() < 0.05
    assert_equal(got[~ambiguous], want[~ambiguous])
    assert (got[:, :, 0] >= 0).all() and got.max() < 3000


def test_ball_query_no_hit_rows_are_zero_and_padding_is_first_hit():
    xyz = np.array([[[0, 0, 0], [5, 5, 5], [0.1, 0, 0], [9, 9, 9]]],
                   np.float32)
    centers = np.array([[[0, 0, 0], [20, 20, 20]]], np.float32)
    got = tops.ball_query(t(xyz), t(centers), 0.5, 4).numpy()
    assert_equal(got, [[[0, 2, 0, 0], [0, 0, 0, 0]]])
    want = jops.ball_query(jnp.asarray(xyz), jnp.asarray(centers), 0.5, 4)
    assert_equal(got, want)


def test_gather_group_and_query_and_group_match_jax():
    rng = np.random.RandomState(3)
    xyz = rng.randn(2, 200, 3).astype(np.float32)
    feats = rng.randn(2, 200, 5).astype(np.float32)
    inds = rng.randint(0, 200, (2, 40)).astype(np.int32)
    idx = rng.randint(0, 200, (2, 40, 16)).astype(np.int32)
    new_xyz = np.asarray(jops.gather_points(jnp.asarray(xyz), jnp.asarray(inds)))
    assert_equal(tops.gather_points(t(xyz), t(inds)), new_xyz)
    assert_equal(tops.group_points(t(feats), t(idx)),
                 jops.group_points(jnp.asarray(feats), jnp.asarray(idx)))
    for features in (feats, None):
        want = jops.query_and_group(
            jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(idx),
            None if features is None else jnp.asarray(features),
            radius=0.4, normalize_xyz=True)
        got = tops.query_and_group(
            t(xyz), t(new_xyz), t(idx),
            None if features is None else t(features),
            radius=0.4, normalize_xyz=True)
        for g, w in zip(got, want):
            assert_close(g, w, atol=0, rtol=1e-7)


def test_three_nn_and_interpolation_match_jax():
    rng = np.random.RandomState(4)
    unknown = rng.randn(2, 300, 3).astype(np.float32)
    known = rng.randn(2, 80, 3).astype(np.float32)
    known[:, 40:] = known[:, :40]  # duplicate known points: index ties
    feats = rng.randn(2, 80, 7).astype(np.float32)
    wd, wi = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    gd, gi = tops.three_nn(t(unknown), t(known))
    assert_equal(gi, wi)
    assert_close(gd, wd)
    assert_close(
        tops.interpolate_features(t(unknown), t(known), t(feats)),
        jops.interpolate_features(jnp.asarray(unknown), jnp.asarray(known),
                                  jnp.asarray(feats)))


@pytest.mark.parametrize("cls_aware,old_type,with_valid", [
    (True, False, True), (False, False, False), (True, True, False),
])
def test_nms_matches_jax(cls_aware, old_type, with_valid):
    rng = np.random.RandomState(5)
    B, K = 2, 128
    lo = rng.uniform(-2, 2, (B, K, 3)).astype(np.float32)
    aabb = np.concatenate(
        [lo, lo + rng.uniform(0.2, 1.5, (B, K, 3)).astype(np.float32)], -1)
    score = rng.uniform(0, 1, (B, K)).astype(np.float32)
    score[:, ::7] = score[:, 1:2]  # exact score ties: the stable order
    cls = rng.randint(0, 3, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) > 0.2
    want = jops.nms_3d(
        jnp.asarray(aabb), jnp.asarray(score),
        jnp.asarray(cls) if cls_aware else None, 0.25, old_type=old_type,
        valid=jnp.asarray(valid) if with_valid else None)
    got = tops.nms_3d(t(aabb), t(score), t(cls) if cls_aware else None, 0.25,
                      old_type=old_type,
                      valid=t(valid) if with_valid else None)
    assert got.dtype == torch.bool
    assert_equal(got, want)
    assert 0 < got.sum() < B * K


def test_box_codecs_match_jax():
    rng = np.random.RandomState(6)
    B, K = 2, 50
    hcls = rng.randint(0, 12, (B, K)).astype(np.int32)
    hres = rng.uniform(-0.3, 0.3, (B, K)).astype(np.float32)
    scls = rng.randint(0, 8, (B, K)).astype(np.int32)
    sres = rng.uniform(-0.2, 0.2, (B, K, 3)).astype(np.float32)
    means = rng.uniform(0.2, 1.5, (8, 3)).astype(np.float32)
    center = rng.randn(B, K, 3).astype(np.float32)

    angle = jops.class2angle(jnp.asarray(hcls), jnp.asarray(hres), 12)
    assert_close(tops.class2angle(t(hcls), t(hres), 12), angle)
    size = jops.class2size(jnp.asarray(scls), jnp.asarray(sres),
                           jnp.asarray(means))
    assert_close(tops.class2size(t(scls), t(sres), t(means)), size)
    cam = jops.flip_axis_to_camera(jnp.asarray(center))
    assert_equal(tops.flip_axis_to_camera(t(center)), cam)
    assert_equal(tops.flip_axis_to_depth(t(np.asarray(cam))), center)
    corners = jops.get_3d_box_batch(size, -angle, cam)
    got_corners = tops.get_3d_box_batch(t(np.asarray(size)),
                                        -t(np.asarray(angle)),
                                        t(np.asarray(cam)))
    assert_close(got_corners, corners)
    aabb = jops.corners_to_aabb(corners)
    assert_equal(tops.corners_to_aabb(t(np.asarray(corners))), aabb)
    assert_close(tops.aabb_pairwise_iou(t(np.asarray(aabb))[0]),
                 jops.aabb_pairwise_iou(aabb[0]))
