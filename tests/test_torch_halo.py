"""The port's slab layout with halo exchange (`rfdnet_tpu_torch/parallel/
halo.py`) at 2 and 4 gloo ranks on the CPU, against the JAX package's
`parallel/halo.py` (8-device virtual mesh) and the one-device ops, at
`tests/test_halo_shard.py`'s sizes.

The halo ball query must equal the one-device ball query on the unsorted
cloud index for index, centers on slab edges included; bucketed FPS must
equal exact FPS when its budget covers the cloud (also without the
near-origin exclusion, on a cloud around the origin that holds a point
at it) and stay within 1.3x exact FPS's covering radius at k = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfdnet_tpu.ops.ball_query import ball_query
from rfdnet_tpu.ops.fps import furthest_point_sample
from rfdnet_tpu.parallel import halo as jhalo
from rfdnet_tpu.parallel.point_shard import make_point_mesh
from rfdnet_tpu_torch.parallel import halo
from torch_parity import assert_equal, t
import torch_dist

B, N = 2, 2048
N_DEV = 8  # the JAX mesh; the port's worlds divide it
RADIUS = 0.08
NSAMPLE = 16
NPOINT = 256


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(3)
    # away from the origin and x-spread, so equal-count slabs are wider
    # than RADIUS
    xyz = rng.uniform(0.2, 1.8, (B, N, 3)).astype(np.float32)
    xs, ids = halo.slab_sort(t(xyz))
    jxs, jids = jhalo.slab_sort(jnp.asarray(xyz))
    assert_equal(xs, jxs)
    assert_equal(ids, jids)
    # around the origin, with a point at it
    centred = rng.uniform(-1.8, 1.8, (B, N, 3)).astype(np.float32)
    centred[:, 7] = 0.0
    cs, _ = halo.slab_sort(t(centred))
    return xyz, xs.numpy(), ids.numpy(), cs.numpy()


def _centers() -> np.ndarray:
    """A spread of sorted indices over all slabs, and each of the 8 slabs'
    first and last index (the 2- and 4-slab edges among them)."""
    M = 64
    cidx = np.broadcast_to(np.linspace(0, N - 1, M).astype(np.int64),
                           (B, M)).copy()
    nl = N // N_DEV
    cidx[:, :N_DEV] = [k * nl for k in range(N_DEV)]
    cidx[:, N_DEV:2 * N_DEV] = [(k + 1) * nl - 1 for k in range(N_DEV)]
    return cidx


def _fps_cases(xs, cs):
    k_cover = N // NPOINT  # k npoint / world >= n_loc: the whole cloud
    return [("fps_cover", xs, NPOINT, k_cover, True),
            ("fps_k4", xs, NPOINT, 4, True),
            ("fps_cover_all", cs, NPOINT, k_cover, False)]


@pytest.fixture(scope="module")
def jax_side(cloud):
    xyz, xs, ids, cs = cloud
    mesh = make_point_mesh(jax.devices()[:N_DEV])
    cidx = jnp.asarray(_centers())
    jxs = jnp.asarray(xs)
    H = jhalo.required_halo(xs, RADIUS, N_DEV)
    centers = jnp.take_along_axis(jxs, cidx[..., None], axis=1)
    out = {"bq_halo": jhalo.ball_query_halo(
               jxs, jnp.asarray(ids), cidx, RADIUS, NSAMPLE, H, mesh),
           "bq": ball_query(jnp.asarray(xyz), centers, RADIUS, NSAMPLE),
           "fps": furthest_point_sample(jxs, NPOINT, impl="xla"),
           "fps_all": furthest_point_sample(jnp.asarray(cs), NPOINT,
                                            impl="xla",
                                            skip_near_origin=False),
           "fps_cover": jhalo.fps_bucketed(jxs, NPOINT, mesh,
                                           k=N // NPOINT)}
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, cloud):
    world = request.param
    _, xs, ids, cs = cloud
    H = halo.required_halo(xs, RADIUS, world)
    res = torch_dist.run(torch_dist.halo_rank, world, xs, ids, _centers(),
                         RADIUS, NSAMPLE, H, _fps_cases(xs, cs))
    return world, H, res


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_required_halo_matches_jax(cloud, n_dev):
    _, xs, _, _ = cloud
    H = halo.required_halo(xs, RADIUS, n_dev)
    assert H == jhalo.required_halo(xs, RADIUS, n_dev)
    # uniform density: ~N r / extent points a boundary strip
    assert 0 < H < N // n_dev


def test_required_halo_refuses_narrow_slabs(cloud):
    _, xs, _, _ = cloud
    with pytest.raises(ValueError, match="wide < radius"):
        halo.required_halo(xs, 0.5, 8)


def test_ball_query_halo_matches_single_device(ranks, jax_side):
    world, H, res = ranks
    assert 0 < H < N // world
    assert_equal(jax_side["bq_halo"], jax_side["bq"])
    for r in res:
        assert_equal(r["bq"], jax_side["bq"])


def test_fps_bucketed_exact_when_budget_covers_cloud(ranks, jax_side):
    _, _, res = ranks
    for r in res:
        assert_equal(r["fps_cover"], jax_side["fps"])
        assert_equal(r["fps_cover"], jax_side["fps_cover"])
        assert_equal(r["fps_cover_all"], jax_side["fps_all"])


def _covering_radius(xyz, idx):
    sel = np.take_along_axis(xyz, idx[..., None], axis=1)
    d = np.linalg.norm(xyz[:, :, None, :] - sel[:, None, :, :], axis=-1)
    return d.min(axis=2).max(axis=1)  # (B,)


def test_fps_bucketed_quality_at_small_k(ranks, jax_side, cloud):
    _, xs, _, _ = cloud
    _, _, res = ranks
    o = res[0]["fps_k4"]
    for r in res:
        assert_equal(r["fps_k4"], o)
    assert ((o >= 0) & (o < N)).all()
    for b in range(B):
        assert len(np.unique(o[b])) == NPOINT
    r_b = _covering_radius(xs, o)
    r_e = _covering_radius(xs, jax_side["fps"])
    assert (r_b <= 1.3 * r_e).all(), (r_b, r_e)
