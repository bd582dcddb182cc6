"""Refine and normals of `Generator3D` through the model's decoder, in the
port against `rfdnet_tpu`'s, on the CPU: all options on the dense route
(the host-MISE route: `test_torch_refine_mise.py`), the port's own draws,
and the differentiable decoder against the fused one.

Tolerances: refine and normals through the model's decoder (the port's
`ISCNet.gradient_decoder`, JAX's f32 flax chain, the same weights), with
JAX's Dirichlet draws injected: faces equal, refined vertices within atol
1e-5 (a step moves a vertex by at most ~3.2 x lr = 3.2e-4; the two
packages' f32 decoders differ in the last places), normals within atol
1e-4 (unit vectors from f32 gradients); on the host-MISE route JAX's
generator meshes the port's octrees' grids, which are held to JAX's
within atol 1e-4, rtol 1e-3 (QEM's collapse choices turn on differences in
the last places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.meshing import generator as jgenerator
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu_torch.meshing import generator as tgenerator
from torch_parity import iscnet_decoder_pair, t

VERT_ATOL, NORMAL_ATOL = 1e-5, 1e-4


RES0, NB, STEPS = 6, 8, 3
VALID = np.array([True, True, False, False, False, True, True, False])


@pytest.fixture(scope="module")
def pair():
    return iscnet_decoder_pair(generate_limit=NB)


@pytest.fixture(scope="module")
def codes():
    """Conditioning codes of NB proposals whose surfaces cross the box."""
    rng = np.random.RandomState(3)
    return (rng.randn(NB, 512).astype(np.float32) * 0.5,
            np.eye(8, dtype=np.float32)[rng.randint(0, 8, NB)])


def _jax_decode(model, variables):
    fn = jax.jit(lambda f, c, p: model.apply(
        variables, f, c, p, method=ISCNet.decode_occupancy))
    return lambda f, c, p: fn(f, c, p)


def jax_draws(nfaces, steps, seed=0):
    """(steps, k, max F, 3): the draws of JAX's `refine_mesh` for meshes of
    `nfaces` faces (each from `split(PRNGKey(seed), steps)`, over its
    power-of-two face bucket), the first F_i of mesh i's."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    out = np.zeros((steps, len(nfaces), max(nfaces), 3), np.float32)
    for i, f in enumerate(nfaces):
        fb = jgenerator._bucket_pow2(f)
        for s in range(steps):
            g = jnp.maximum(jax.random.gamma(keys[s], 0.5, (fb, 3)), 1e-9)
            out[s, i, :f] = np.asarray(g / jnp.sum(g, axis=1, keepdims=True)
                                       )[:f]
    return out


def _inject_jax_draws(monkeypatch, gen):
    refine = gen.refine_meshes

    def with_draws(meshes, rows, decode, steps, **kw):
        kw["eps"] = jax_draws([len(m.faces) for m in meshes], steps)
        return refine(meshes, rows, decode, steps, **kw)

    monkeypatch.setattr(gen, "refine_meshes", with_draws)


def _generators(pair, route):
    model, variables, port = pair
    decode = _jax_decode(model, variables)
    steps = 0 if route == "dense" else 1
    kw = dict(resolution0=RES0, upsampling_steps=steps,
              refinement_step=STEPS, simplify_nfaces=60, with_normals=True)
    want = jgenerator.Generator3D(decode, mise_impl="host", **kw)
    got = tgenerator.Generator3D(
        port.decode_occupancy, mise_impl="host",
        bind_fn=port.occupancy_decoder,
        grad_bind_fn=port.gradient_decoder, **kw)
    return got, want


def check_generator_options(pair, codes, monkeypatch, route):
    """Simplify inside extraction, then refine, then normals, of 8 slots
    (4 valid) at resolution 6: on the dense route both generators mesh
    JAX's grids; on the host-MISE route the port runs its own octrees and
    decodes."""
    f, c = codes
    got_gen, want_gen = _generators(pair, route)
    _inject_jax_draws(monkeypatch, got_gen)
    if route == "dense":
        grids = np.asarray(want_gen.decode_fn(
            f, c, np.broadcast_to(
                1.1 * np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, RES0)] * 3,
                                           indexing="ij"), -1).reshape(-1, 3),
                (NB, RES0 ** 3, 3)).astype(np.float32))).reshape(
            NB, RES0, RES0, RES0)
    else:
        # the port's octrees decode in f32 apart from JAX's, and QEM's
        # collapses turn on differences in the last places: JAX meshes the
        # port's grids, which are held to its own
        got = got_gen.generate_meshes(t(f), t(c), valid=t(VALID))
        grids = got_gen.mise_grids(t(f), t(c))
        np.testing.assert_allclose(grids, want_gen._mise_grids(f, c),
                                   atol=1e-4, rtol=1e-3)
    if route == "dense":
        got = got_gen.meshes_from_grids(grids, VALID, t(f), t(c))
    want = want_gen.meshes_from_grids(grids, VALID, f, c)
    assert set(got_gen.last_ms) == {"extract", "simplify", "refine",
                                    "normals"}
    first, last = got_gen.refine_losses
    assert np.isfinite(first) and np.isfinite(last)
    refined = 0
    for i in range(NB):
        if not VALID[i]:
            assert len(got[i].vertices) == 0
            continue
        if len(want[i].vertices) == 0:
            assert len(got[i].vertices) == 0
            continue
        np.testing.assert_array_equal(got[i].faces, want[i].faces)
        np.testing.assert_allclose(got[i].vertices, want[i].vertices,
                                   atol=VERT_ATOL, rtol=0)
        np.testing.assert_allclose(got[i].vertex_normals,
                                   want[i].vertex_normals, atol=NORMAL_ATOL,
                                   rtol=0)
        norms = np.linalg.norm(got[i].vertex_normals, axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-6)
        refined += 1
    assert refined >= 2


def test_generator_options_match_jax(pair, codes, monkeypatch):
    check_generator_options(pair, codes, monkeypatch, "dense")


def test_refine_moves_vertices_and_default_draws_differ(pair, codes):
    """Without injected draws the port draws its own (seed 0, shared by the
    scene's meshes): the vertices move, by at most steps x 3.2 x lr, and a
    second call gives the same result."""
    _, _, port = pair
    f, c = codes
    gen = tgenerator.Generator3D(None, resolution0=RES0,
                                 bind_fn=port.occupancy_decoder)
    grids = gen.decode_grids(t(f), t(c)).numpy()
    meshes = [m for m in gen.meshes_from_grids(grids)]
    rows = [i for i, m in enumerate(meshes) if len(m.faces)][:3]
    decode = port.gradient_decoder(t(f), t(c))
    a = gen.refine_meshes([meshes[i] for i in rows], rows, decode, STEPS)
    b = gen.refine_meshes([meshes[i] for i in rows], rows, decode, STEPS)
    for i, ma, mb in zip(rows, a, b):
        moved = np.abs(ma.vertices - meshes[i].vertices).max()
        assert 0 < moved <= STEPS * 3.2e-4
        np.testing.assert_array_equal(ma.vertices, mb.vertices)
        np.testing.assert_array_equal(ma.faces, meshes[i].faces)


def test_gradient_decoder_matches_fused_decode(pair, codes):
    """The differentiable chain decodes what the fused one does (within
    the f32 tolerance), on rows and on all proposals, and with the sampled
    z."""
    _, _, port = pair
    f, c = codes
    p = t(np.random.RandomState(5).uniform(-0.55, 0.55, (NB, 64, 3))
          .astype(np.float32))
    for sample in (False, True):
        fused = port.occupancy_decoder(t(f), t(c), sample=sample)
        chain = port.gradient_decoder(t(f), t(c), sample=sample)
        want = fused(p)
        torch.testing.assert_close(chain(p), want, atol=1e-4, rtol=1e-4)
        rows = torch.tensor([5, 2])
        torch.testing.assert_close(chain(p[rows], rows), want[rows],
                                   atol=1e-4, rtol=1e-4)
    port.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            port.gradient_decoder(t(f), t(c))
    finally:
        port.eval()
