"""MISE of the port against `rfdnet_tpu`'s, on the CPU: the octree of one
proposal (`MISE`, `MiseNative`), the host octrees in lock-step
(`mise_value_grids`), the device octree (`mise_device`, run here on the
CPU), the sparse-replay marching cubes, `Generator3D` at
`upsampling_steps > 0`, and the sampled z (`use_sampling`).

Tolerances:
- on the analytic field `40 (0.35 - |p - f|)` (the sphere of
  `tests/test_meshing.py`, evaluated in float64 from the same float32
  points in both packages), query sequences, dense grids, active counts
  and meshes are identical;
- with the model's decode (the port's fused decoder, the JAX package's f32
  flax chain, the same weights), values decoded by both are within atol
  1e-4 x max(scale, 1), rtol 1e-3; a voxel that one octree refines and the
  other does not must have a corner within that tolerance of the iso
  level, or a corner that only one of them decoded (a parent refined by
  one alone); meshes are compared where `chip_smoke.mesh_comparable`
  allows;
- the sparse replay's meshes are byte-identical to marching cubes over the
  dense reconstruction, and to the JAX library's replay.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rfdnet_tpu.meshing import generator as jgenerator
from rfdnet_tpu.meshing import mise as jmise
from rfdnet_tpu.meshing import native as jnative
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu_torch.meshing import mise as tmise
from rfdnet_tpu_torch.meshing import mise_device
from rfdnet_tpu_torch.meshing import native as tnative
from rfdnet_tpu_torch.meshing.generator import Generator3D
from torch_parity import assert_equal, iscnet_pair, t

ISO = 0.0  # logit(0.5)


def sphere(f, p):
    """40 (0.35 - |p - f|) per proposal, in float64 from float32 points."""
    p = np.asarray(p, np.float64)
    f = np.asarray(f, np.float64)[:, None, :]
    return (40 * (0.35 - np.linalg.norm(p - f, axis=-1))).astype(np.float32)


def sphere_torch(f, c, p):
    return torch.from_numpy(sphere(f.numpy(), p.numpy()))


def sphere_jax(f, c, p):
    return sphere(f, p)


def centres(nb: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.12, 0.12, (nb, 3)).astype(np.float32),
            np.zeros((nb, 8), np.float32))


def meshes_equal(a, b):
    assert [len(m.faces) for m in a] == [len(m.faces) for m in b]
    for x, y in zip(a, b):
        assert_equal(x.vertices, y.vertices)
        assert_equal(x.faces, y.faces)


# ------------------------------------------------------------ one octree
@pytest.mark.parametrize("impl", ["python", "native"])
@pytest.mark.parametrize("res0, depth", [(4, 2), (5, 3)])
def test_octree_queries_and_dense_match_jax(impl, res0, depth):
    f = centres(1, depth)[0]
    make = {"python": (tmise.MISE, jmise.MISE),
            "native": (tnative.MiseNative, jnative.MiseNative)}[impl]
    ours, theirs = make[0](res0, depth, ISO), make[1](res0, depth, ISO)
    R = res0 * 2 ** depth
    rounds = 0
    while not theirs.done():
        q = theirs.query()
        assert_equal(ours.query(), q)
        v = sphere(f, (1.1 * (q.astype(np.float32) / R - 0.5))[None])[0]
        ours.update(q, v)
        theirs.update(q, v)
        rounds += 1
    assert ours.done() and rounds == depth + 1
    assert_equal(ours.to_dense(), theirs.to_dense())


# ------------------------------------------------- octrees on the sphere
@pytest.mark.parametrize("res0, steps", [(4, 2), (6, 1), (3, 3)])
def test_host_and_device_octrees_match_jax(res0, steps):
    """The host octrees (`mise_value_grids`) and the device octree
    (`mise_device`, its dense reconstruction) against JAX's
    `mise_value_grids`; the sparse replay against dense marching cubes,
    in the port and in the JAX library."""
    f, c = centres(3, res0)
    want = jmise.mise_value_grids(sphere_jax, f, c, res0, steps, 0.5, 0.1)
    gen = Generator3D(sphere_torch, resolution0=res0,
                      upsampling_steps=steps)
    assert_equal(gen.mise_grids(t(f), t(c)), want)
    out = gen.run_octree(t(f), t(c))
    dense = mise_device.reconstruct_dense(
        out.lvl0, out.idx, out.vals, out.level_counts, res0, steps)
    assert_equal(dense, want)
    # active voxels a level: those of JAX's device octree
    assert [lv["active"] for lv in out.levels[1:]] == _jax_device_totals(
        f, c, res0, steps)
    host = {k: getattr(out, k).numpy()
            for k in ("lvl0", "idx", "vals", "level_counts")}
    replay = gen.meshes_from(host)
    meshes_equal(replay, gen.meshes_from_grids(want))
    pairs = jnative.mise_marching_cubes_batch(
        host["lvl0"], res0, steps, host["idx"], host["vals"],
        host["level_counts"], ISO)
    ours = tnative.mise_marching_cubes_batch(
        host["lvl0"], res0, steps, host["idx"], host["vals"],
        host["level_counts"], ISO)
    for (v, tr), (w, wt) in zip(ours, pairs):
        assert_equal(v, w)
        assert_equal(tr, wt)
    assert all(len(m.faces) for m in replay)
    # one proposal alone: its levels' ids and values as lists
    counts = host["level_counts"]
    ends = np.cumsum(counts.reshape(-1))
    cut = [slice(e - n, e) for e, n in zip(ends[:steps], counts[0])]
    v, tr = tnative.mise_marching_cubes(
        host["lvl0"][0], res0, steps, [host["idx"][c] for c in cut],
        [host["vals"][c] for c in cut], ISO)
    assert_equal(v, ours[0][0])
    assert_equal(tr, ours[0][1])


def _jax_device_totals(f, c, res0, steps):
    """The true active voxels a level of JAX's device octree
    (`make_mise_device_global`, budgets of every voxel) on the sphere,
    decoded through a host callback in float64 as above."""
    from rfdnet_tpu.meshing.mise_device import make_mise_device_global

    def decode(fj, cj, p):
        return jax.pure_callback(
            sphere, jax.ShapeDtypeStruct(p.shape[:2], jnp.float32), fj, p)

    budgets = [(res0 * 2 ** l) ** 3 * len(f) for l in range(steps)]
    fn = make_mise_device_global(decode, res0, steps, 0.5, 0.1, budgets,
                                 sparse_budget=1 << 20,
                                 out_dtype=jnp.float32)
    return [int(x) for x in jax.jit(fn)(jnp.asarray(f), jnp.asarray(c))[3]]


@pytest.mark.parametrize("impl", ["device", "host"])
def test_generator_meshes_match_jax_host_octree(impl):
    """`Generator3D.generate_meshes` at two upsampling steps, both octree
    routes, against JAX's `Generator3D(mise_impl="host")`: identical
    arrays; an invalid slot gets an empty mesh."""
    f, c = centres(3, 7)
    valid = np.array([True, False, True])
    want = jgenerator.Generator3D(
        sphere_jax, resolution0=4, upsampling_steps=2,
        mise_impl="host").generate_meshes(f, c, valid=valid)
    got = Generator3D(sphere_torch, resolution0=4, upsampling_steps=2,
                      mise_impl=impl).generate_meshes(t(f), t(c),
                                                      valid=t(valid))
    meshes_equal(got, want)
    assert len(got[0].faces) and not len(got[1].faces)


# ------------------------------------------------------- the model decode
RES0, STEPS, NB = 6, 2, 3


@pytest.fixture(scope="module")
def pair():
    return iscnet_pair(generate_limit=8)


@pytest.fixture(scope="module")
def codes():
    """Conditioning codes of NB proposals whose surfaces cross the box."""
    rng = np.random.RandomState(3)
    return (rng.randn(NB, 512).astype(np.float32) * 0.5,
            np.eye(8, dtype=np.float32)[rng.randint(0, 8, NB)])


def _jax_decode(model, variables, rng=None):
    fn = jax.jit(lambda f, c, p: model.apply(
        variables, f, c, p, method=ISCNet.decode_occupancy, rng=rng))
    return lambda f, c, p: np.asarray(fn(f, c, p))


def _jax_trees(monkeypatch, decode, f, c):
    """JAX's `mise_value_grids` with its Python octree, whose values (NaN
    where unknown) the test reads afterwards."""
    trees = []

    def tree(*args):
        trees.append(jmise.MISE(*args))
        return trees[-1]

    monkeypatch.setattr(jmise, "_make_tree", tree)
    grids = jmise.mise_value_grids(decode, f, c, RES0, STEPS, 0.5, 0.1)
    return grids, np.stack([tr.values for tr in trees])


def _port_lattice(out) -> np.ndarray:
    """A device octree's decoded values on the (R+1)^3 lattice, NaN where
    it decoded nothing."""
    R = RES0 * 2 ** STEPS
    vals = np.full((NB, R + 1, R + 1, R + 1), np.nan)
    s0 = 2 ** STEPS
    vals[:, ::s0, ::s0, ::s0] = out.lvl0.numpy()
    counts = out.level_counts.numpy()
    idx, v = out.idx.numpy().astype(np.int64), out.vals.numpy()
    k = 0
    for i in range(NB):
        for l in range(STEPS):
            s, n = 2 ** (STEPS - l), RES0 * 2 ** l
            for e in range(k, k + counts[i, l]):
                base = np.array([idx[e] // (n * n), idx[e] // n % n,
                                 idx[e] % n]) * s
                pts = base + mise_device.offsets(s).numpy()
                vals[i, pts[:, 0], pts[:, 1], pts[:, 2]] = v[e]
            k += counts[i, l]
    return vals


def _check_octrees(got, want):
    """Values both decoded within tolerance; each voxel one octree refines
    and the other does not has a corner near the iso level or a corner
    only one of them decoded. Returns the voxels refined by one alone."""
    scale = max(float(np.nanmax(np.abs(want))), 1.0)
    tol = 1e-4 * scale
    both = ~np.isnan(got) & ~np.isnan(want)
    assert both.sum() > 0
    np.testing.assert_allclose(got[both], want[both], atol=tol, rtol=1e-3)
    differing = 0
    for l in range(STEPS):
        s, n = 2 ** (STEPS - l), RES0 * 2 ** l
        corners = lambda a: np.stack(
            [a[:, dx * s::s][:, :n, dy * s::s][:, :, :n, dz * s::s][..., :n]
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], -1)
        cg, cw = corners(got), corners(want)

        def active(cv):
            known = ~np.isnan(cv).any(-1)
            occ = (np.nan_to_num(cv, nan=-np.inf) >= ISO).sum(-1)
            return known & (occ > 0) & (occ < 8)

        diff = active(cg) != active(cw)
        near = (np.abs(np.where(np.isnan(cw), np.inf, cw)) <= tol).any(-1)
        one_sided = (np.isnan(cg) != np.isnan(cw)).any(-1)
        assert (near | one_sided)[diff].all(), f"level {l}"
        differing += int(diff.sum())
    return differing


@pytest.mark.parametrize("impl", ["device", "host"])
def test_model_decode_octrees_within_tolerance(pair, codes, monkeypatch,
                                               impl):
    """The model's decode at resolution 6, two steps, three proposals: the
    port's device octree or host octrees against JAX's host octrees;
    meshes where comparable."""
    model, variables, port = pair
    f, c = codes
    want, jvals = _jax_trees(monkeypatch, _jax_decode(model, variables), f, c)
    gen = Generator3D(port.decode_occupancy, resolution0=RES0,
                      upsampling_steps=STEPS, mise_impl=impl,
                      bind_fn=port.occupancy_decoder)
    if impl == "device":
        out = gen.run_octree(t(f), t(c))
        assert out.levels[1]["active"] > 0
        _check_octrees(_port_lattice(out), jvals)
        grids = mise_device.reconstruct_dense(
            out.lvl0, out.idx, out.vals, out.level_counts, RES0,
            STEPS).numpy()
    else:
        trees = []
        monkeypatch.setattr(tmise, "_make_tree", lambda *a: trees.append(
            tmise.MISE(*a)) or trees[-1])
        grids = gen.mise_grids(t(f), t(c))
        _check_octrees(np.stack([tr.values for tr in trees]), jvals)
        monkeypatch.undo()
        assert_equal(gen.mise_grids(t(f), t(c)), grids)  # MiseNative
    _compare_meshes(gen, grids, want)


def _compare_meshes(gen, grids, want):
    got_m = gen.meshes_from_grids(grids)
    want_m = jgenerator.Generator3D(None, resolution0=RES0,
                                    upsampling_steps=STEPS
                                    ).meshes_from_grids(want)
    cell = 1.1 / (RES0 * 2 ** STEPS)
    compared = 0
    for g in range(NB):
        ok, tol = chip_smoke.mesh_comparable(grids[g], want[g])
        if ok:
            assert_equal(got_m[g].faces, want_m[g].faces)
            if len(got_m[g].vertices):
                assert np.abs(got_m[g].vertices - want_m[g].vertices).max() \
                    <= tol * cell + 1e-12
            compared += 1
    assert compared > 0


# ------------------------------------------------------------ sampled z
@pytest.mark.parametrize("route", ["dense", "host_octree"])
def test_use_sampling_matches_jax(pair, codes, monkeypatch, route):
    """JAX's draw `normal(PRNGKey(42), (Nb, z_dim))` injected into the
    port's decode, against JAX's decode with `rng=PRNGKey(42)`: the dense
    route's grids within tolerance, the host octrees as
    `_check_octrees` holds them; and `ISCNet.sample_z` draws one z a
    proposal, the same on each call."""
    model, variables, port = pair
    f, c = codes
    jdecode = _jax_decode(model, variables, rng=jax.random.PRNGKey(42))
    z = t(jax.random.normal(jax.random.PRNGKey(42), (NB, 32)))
    bind = functools.partial(port.occupancy_decoder, z=z)
    if route == "dense":
        pts = 1.1 * (np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, 8)] * 3,
                                          indexing="ij"), -1).reshape(-1, 3))
        pts = np.broadcast_to(pts.astype(np.float32), (NB, 512, 3))
        want = jdecode(f, c, pts)
        got = Generator3D(None, resolution0=8, bind_fn=bind).decode_grids(
            t(f), t(c)).reshape(NB, -1).numpy()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-3)
        prior = port.decode_occupancy(t(f), t(c), t(pts)).numpy()
        assert np.abs(prior - want).max() > 1e-2 * scale
    else:
        want, jvals = _jax_trees(monkeypatch, jdecode, f, c)
        trees = []
        monkeypatch.setattr(tmise, "_make_tree", lambda *a: trees.append(
            tmise.MISE(*a)) or trees[-1])
        gen = Generator3D(None, resolution0=RES0, upsampling_steps=STEPS,
                          mise_impl="host", bind_fn=bind)
        grids = gen.mise_grids(t(f), t(c))
        _check_octrees(np.stack([tr.values for tr in trees]), jvals)
        _compare_meshes(gen, grids, want)
    a, b = port.sample_z(NB), port.sample_z(NB)
    assert torch.equal(a, b) and a.shape == (NB, 32)
    assert not torch.equal(a[0], a[1])
