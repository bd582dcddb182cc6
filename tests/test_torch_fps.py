"""The port's FPS (`rfdnet_tpu_torch/ops/fps.py`) on the CPU: its plain
version against the JAX package's scan (`_fps_xla`) and its Pallas kernel
under the interpreter (`_fps_pallas(..., interpret=True)`), and the
function that chooses the CUDA kernel's launch for a cloud size.

Inputs come from a numpy seed and go to both packages. Indices are exact:
the cases are the ones an argmax spread over threads, warps and CTAs is
likeliest to get wrong (ties, points that are never candidates, sizes that
fill no tile).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rfdnet_tpu.ops import fps as jfps
from rfdnet_tpu_torch.ops import fps as tfps
from torch_parity import assert_equal, t


def _batch2_different(rng):
    return rng.uniform(-2, 2, (2, 640, 3)).astype(np.float32) * np.array(
        [[[1.0]], [[0.5]]], np.float32), 96


def _n_not_multiple_of_128(rng):
    return rng.uniform(-2, 2, (1, 333, 3)).astype(np.float32), 64


def _exact_duplicates(rng):
    base = rng.uniform(-2, 2, (2, 100, 3)).astype(np.float32)
    return base[:, rng.randint(0, 100, 500)], 120  # past the distinct points


def _near_origin_block(rng):
    xyz = rng.uniform(-2, 2, (2, 400, 3)).astype(np.float32)
    xyz[:, 1:150] *= 1e-3  # |p|^2 <= 1e-3: never candidates, index 1 too
    return xyz, 100


def _all_near_origin(rng):
    return rng.uniform(-2, 2, (1, 200, 3)).astype(np.float32) * 1e-3, 20


def _npoint_over_n(rng):
    return rng.uniform(-2, 2, (2, 50, 3)).astype(np.float32), 80


@pytest.mark.parametrize("make", [
    _batch2_different, _n_not_multiple_of_128, _exact_duplicates,
    _near_origin_block, _all_near_origin, _npoint_over_n,
], ids=lambda f: f.__name__.lstrip("_"))
def test_plain_matches_xla_and_pallas_interpret(make):
    xyz, npoint = make(np.random.RandomState(7))
    got = tfps.fps_plain(t(xyz), npoint)
    assert_equal(got, jfps._fps_xla(jnp.asarray(xyz), npoint, True))
    assert_equal(got, jfps._fps_pallas(jnp.asarray(xyz), npoint, True,
                                       interpret=True))
    if make is _all_near_origin:  # argmax of all -1: index 0 at every step
        assert not got.any()


@pytest.mark.parametrize("make", [
    _batch2_different, _exact_duplicates, _near_origin_block,
    _all_near_origin,
], ids=lambda f: f.__name__.lstrip("_"))
def test_plain_without_near_origin_skip(make):
    """`skip_near_origin=False`: every point is a candidate, the points
    near the origin included, as in JAX's scan and Pallas kernel."""
    xyz, npoint = make(np.random.RandomState(7))
    got = tfps.fps_plain(t(xyz), npoint, skip_near_origin=False)
    assert_equal(got, jfps._fps_xla(jnp.asarray(xyz), npoint, False))
    assert_equal(got, jfps._fps_pallas(jnp.asarray(xyz), npoint, False,
                                       interpret=True))
    assert_equal(tfps.furthest_point_sample(t(xyz), npoint,
                                            skip_near_origin=False), got)
    if make is _all_near_origin:  # candidates now: a real selection
        assert got.unique().numel() == npoint


MAIN_PATH_SMALL = (2048, 1024, 512, 1024)  # SA2, SA3, SA4, seed_fps


def test_route_holds_every_cloud_within_the_sm():
    sizes = sorted(set(range(1, 300001, 97)) | set(MAIN_PATH_SMALL)
                   | {80000, 300000}
                   | {r.capacity + d for r in tfps.RESIDENT_ROUTES
                      for d in (-1, 0, 1)})
    for n, b in [(n, b) for n in sizes for b in (1, tfps.BATCH_MIN)]:
        route = tfps.fps_route(n, b)
        assert route.capacity >= n
        if n > tfps.RESIDENT_CAPACITY:
            assert route.kind == "streaming"
            continue
        # the streaming kernel only above what the resident one can hold
        assert route.kind == "resident"
        assert route.cluster in (1, 2, 4, 8, 16)
        assert route.cluster <= tfps.MAX_CLUSTER
        assert route.threads % 32 == 0 and route.threads <= 1024
        assert route.shared_bytes <= tfps.SHARED_LIMIT
        assert (route.point_registers + tfps.REGISTER_HEADROOM
                <= route.register_limit)
        # no CTA of the cluster is left without a point
        assert n > (route.cluster - 1) * route.threads
    for n in MAIN_PATH_SMALL:
        assert tfps.fps_route(n).cluster == 1
    assert tfps.fps_route(80000).cluster > 1
    # a train step's batch of 8 takes clusters of 8 at 80000 points
    assert tfps.fps_route(80000, 8) == tfps.FpsRoute("resident", 8, 512, 20)
    assert tfps.fps_route(80000, 7) == tfps.fps_route(80000)


def test_routes_are_ordered_and_instantiated():
    """Capacities rise, and the CUDA source instantiates exactly the launch
    shapes the table names and the stub of each (in a cluster, threads)."""
    import re

    caps = [r.capacity for r in tfps.RESIDENT_ROUTES]
    assert caps == sorted(set(caps))
    src = (tfps._native.CSRC / "fps.cu").read_text()
    macro = src[src.index("#define FPS_RESIDENT_SHAPES"):]
    shapes = {(c == "true", int(t), int(p), s == "true") for c, t, p, s in
              re.findall(r"X\((true|false), (\d+), (\d+), (true|false)\)",
                         macro[:macro.index("\n\n")])}
    routes = {(r.cluster > 1, r.threads, r.ppt, False)
              for r in (*tfps.RESIDENT_ROUTES, *tfps.BATCH_ROUTES.values())}
    stubs = {(c, t, 1, True) for c, t, _, _ in routes}
    assert shapes == routes | stubs
