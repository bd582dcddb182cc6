"""The port's point-sharded SA1 (`rfdnet_tpu_torch/parallel/point_shard.
py`) at 2 and 4 gloo ranks on the CPU, against the JAX package's
`parallel/point_shard.py` on its 8-device virtual mesh and against the
one-process ops of both packages, at `tests/test_point_shard.py`'s sizes.

Every index is exact (the cloud holds a point at the origin, which one
FPS case skips and the other does not); the SA1 features within 1e-5.
JAX's sharded programs compile for seconds each, so its sharded side is
FPS (both settings) and one ball query; the other cases are held to its
one-device ops, which `tests/test_point_shard.py` holds its sharded ones
to. The ranks run in spawned processes (`tests/torch_dist.py`), one run
for each world size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.models.pointnet2 import SetAbstraction as JSetAbstraction
from rfdnet_tpu.ops import (ball_query, furthest_point_sample, gather_points,
                            group_points)
from rfdnet_tpu.parallel import point_shard as jps
from rfdnet_tpu_torch import ops as tops
from rfdnet_tpu_torch.models.pointnet2 import SetAbstraction
from torch_parity import (assert_close, assert_equal, cached_tree,
                          init_flax, load_port, t)
import torch_dist

B, N = 2, 1024
SA_ARGS = dict(npoint=64, radius=0.4, nsample=16, in_features=4,
               mlp=[16, 32], use_xyz=True, normalize_xyz=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    xyz = rng.uniform(-2, 2, size=(B, N, 3)).astype(np.float32)
    xyz[0, 5] = 0.0  # exercise the ||p||^2 <= 1e-3 skip
    r3 = np.random.RandomState(3)
    feats = r3.randn(B, N, 5).astype(np.float32)
    idx2 = r3.randint(0, N, size=(B, 32))
    idx3 = r3.randint(0, N, size=(B, 16, 8))
    sa_feats = np.random.RandomState(5).randn(B, N, 4).astype(np.float32)
    jsa = JSetAbstraction(npoint=64, radius=0.4, nsample=16, mlp=(16, 32),
                          use_xyz=True, normalize_xyz=True, fps_impl="xla")
    variables = init_flax(jsa, 0, jnp.asarray(xyz), jnp.asarray(sa_feats),
                          False)
    return dict(xyz=xyz, feats=feats, idx2=idx2, idx3=idx3,
                sa_feats=sa_feats, jsa=jsa, variables=variables)


@pytest.fixture(scope="module")
def jax_side(inputs):
    """JAX's sharded results on the 8-device mesh and its one-device ops
    (computed once, see `torch_parity.cached_tree`)."""
    def compute():
        mesh = jps.make_point_mesh(jax.devices()[:8])
        x = jnp.asarray(inputs["xyz"])
        f = jnp.asarray(inputs["feats"])
        out = {"fps64": jps.fps_sharded(x, 64, mesh),
               "fps32_all": jps.fps_sharded(x, 32, mesh,
                                            skip_near_origin=False),
               "ref_fps64": furthest_point_sample(x, 64, impl="xla"),
               "ref_fps32_all": furthest_point_sample(
                   x, 32, impl="xla", skip_near_origin=False),
               "gather": gather_points(f, jnp.asarray(inputs["idx2"])),
               "group": group_points(f, jnp.asarray(inputs["idx3"]))}
        centers = gather_points(x, out["ref_fps64"])
        out["bq_0.3_16"] = jps.ball_query_sharded(x, centers, 0.3, 16, mesh)
        out["bq_1.5_8"] = ball_query(x, centers, 1.5, 8)
        out["sa1_xyz"], out["sa1_feat"], out["sa1_inds"] = inputs[
            "jsa"].apply(inputs["variables"], x,
                         jnp.asarray(inputs["sa_feats"]), False)
        return out

    return cached_tree("point_shard_jax", compute, sources=(__file__,))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, inputs):
    port = load_port(SetAbstraction(**SA_ARGS), inputs["variables"])
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    res = torch_dist.run(
        torch_dist.point_shard_rank, request.param, inputs["xyz"],
        inputs["feats"], inputs["idx2"], inputs["idx3"],
        inputs["sa_feats"], SA_ARGS, state)
    return request.param, res


def test_fps_sharded_exact(ranks, jax_side):
    world, res = ranks
    for r in res:
        assert_equal(r["fps64"], jax_side["fps64"])
        assert_equal(r["fps64"], jax_side["ref_fps64"])
        assert_equal(r["fps32_all"], jax_side["fps32_all"])
        assert_equal(r["fps32_all"], jax_side["ref_fps32_all"])


def test_ball_query_sharded_exact(ranks, jax_side, inputs):
    world, res = ranks
    x = t(inputs["xyz"])
    centers = tops.gather_points(x, t(jax_side["ref_fps64"]))
    for radius, ns in [(0.3, 16), (1.5, 8)]:  # few hits / overflow
        key = f"bq_{radius}_{ns}"
        want = tops.ball_query(x, centers, radius, ns)
        assert_equal(want, jax_side[key])
        for r in res:
            assert_equal(r[key], want)
    for r in res:  # centers far away: rows of zeros
        assert_equal(r["bq_far"], np.zeros((B, 4, 8)))


def test_gather_group_sharded_exact(ranks, jax_side):
    world, res = ranks
    for r in res:
        assert_equal(r["gather"], jax_side["gather"])
        assert_equal(r["group"], jax_side["group"])


def test_sa1_forward_sharded_matches_module(ranks, jax_side, inputs):
    world, res = ranks
    port = load_port(SetAbstraction(**SA_ARGS), inputs["variables"])
    with torch.no_grad():
        ref_xyz, ref_feat, ref_inds = port(t(inputs["xyz"]),
                                           t(inputs["sa_feats"]))
    for r in res:
        assert_equal(r["sa1_inds"], ref_inds)
        assert_equal(r["sa1_inds"], jax_side["sa1_inds"])
        assert_equal(r["sa1_xyz"], ref_xyz)
        assert_close(r["sa1_feat"], ref_feat, atol=1e-5, rtol=1e-5)
        assert_close(r["sa1_feat"], jax_side["sa1_feat"], atol=1e-5,
                     rtol=1e-5)
