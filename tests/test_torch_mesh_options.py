"""`Generator3D`'s host options in the port against `rfdnet_tpu`'s, on the
CPU: marching tetrahedra and the QEM simplification (refine and normals
through the model: `test_torch_refine.py`, `test_torch_refine_mise.py`).

Tolerance: arrays identical (same dtype, shape and bytes); both libraries
are built from copies of one source with `-O3 -march=native` on this
host.
"""

import numpy as np
import pytest
import torch

from rfdnet_tpu.meshing import generator as jgenerator
from rfdnet_tpu.meshing import native as jnative
from rfdnet_tpu_torch.meshing import generator as tgenerator
from rfdnet_tpu_torch.meshing import native as tnative
from test_torch_meshing import GRIDS, assert_identical, assert_pairs_identical
from torch_parity import t


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_tetrahedra_matches_jax(name):
    got = tnative.marching_tetrahedra(GRIDS[name], 0.0)
    want = jnative.marching_tetrahedra(GRIDS[name], 0.0)
    assert_pairs_identical([got], [want])


def _meshes():
    """Three meshes of the test grids in the unit box: a sphere, two
    touching spheres, and the noise grid's many small pieces."""
    out = {}
    for name in ("sphere", "touching", "noise"):
        g = np.pad(GRIDS[name], 1, constant_values=-1e6)
        v, f = tnative.marching_cubes(g, 0.0)
        out[name] = (v / (g.shape[0] - 1) - 0.5, f)
    return out


MESHES = _meshes()


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("target, aggressiveness", [(60, 5.0), (200, 7.0)])
def test_simplify_matches_jax(name, target, aggressiveness):
    v, f = MESHES[name]
    got = tnative.simplify_mesh(v, f, target, aggressiveness)
    want = jnative.simplify_mesh(v, f, target, aggressiveness)
    assert len(got[1]) < len(f)
    assert_pairs_identical([got], [want])


def test_simplify_rejects_bad_faces():
    v, f = MESHES["sphere"]
    with pytest.raises(ValueError, match="outside"):
        tnative.simplify_mesh(v, f + len(v), 100)
    with pytest.raises(ValueError, match="expected"):
        tnative.simplify_mesh(v[:, :2], f, 100)


@pytest.mark.parametrize("simplify", [None, 300])
def test_generator_marching_tetrahedra_matches_jax(simplify):
    grids = np.stack([GRIDS[k] for k in ("sphere", "touching", "outside")])
    valid = np.array([True, True, False])
    got = tgenerator.Generator3D(
        None, extractor="marching_tetrahedra",
        simplify_nfaces=simplify).meshes_from_grids(grids, valid)
    want = jgenerator.Generator3D(
        None, extractor="marching_tetrahedra",
        simplify_nfaces=simplify).meshes_from_grids(grids, valid)
    assert len(got[0].faces) > 0 and len(got[2].faces) == 0
    for g, w in zip(got, want):
        assert_identical(g.faces, w.faces.astype(np.int32))
        assert_identical(g.vertices, w.vertices)


def test_marching_tetrahedra_from_the_device_octree_matches_jax():
    """With the device octree, marching tetrahedra meshes the dense
    reconstruction of its outputs: the JAX package's generator over the
    same grids gives identical arrays."""
    from rfdnet_tpu_torch.meshing.mise_device import reconstruct_dense
    from test_torch_mise import centres, sphere_torch

    f, c = centres(3, seed=4)
    gen = tgenerator.Generator3D(sphere_torch, resolution0=4,
                                 upsampling_steps=2,
                                 extractor="marching_tetrahedra")
    out = gen.run_octree(t(f), t(c))
    host = {k: getattr(out, k).numpy() for k in ("lvl0", "idx", "vals",
                                                 "level_counts")}
    got = gen.meshes_from(host)
    grids = reconstruct_dense(out.lvl0, out.idx, out.vals, out.level_counts,
                              4, 2).numpy()
    want = jgenerator.Generator3D(None, resolution0=4, upsampling_steps=2,
                                  extractor="marching_tetrahedra"
                                  ).meshes_from_grids(grids)
    assert all(len(m.faces) for m in got)
    for g, w in zip(got, want):
        assert_identical(g.faces, w.faces.astype(np.int32))
        assert_identical(g.vertices, w.vertices)


def test_options_accepted_and_mise_budgets_refused():
    gen = tgenerator.Generator3D(None, refinement_step=30,
                                 simplify_nfaces=5000, with_normals=True,
                                 extractor="marching_tetrahedra",
                                 grad_bind_fn=lambda f, c: None)
    assert gen.needs_decoder and gen.extractor == "marching_tetrahedra"
    with pytest.raises(ValueError, match="extractor"):
        tgenerator.Generator3D(None, extractor="dual_contouring")
    for option in ({"refinement_step": 30}, {"with_normals": True}):
        with pytest.raises(ValueError, match="grad_bind_fn"):
            tgenerator.Generator3D(None, **option)
    with pytest.raises(ValueError, match="features"):
        gen.meshes_from_grids(GRIDS["sphere"][None])


def test_dirichlet_draws_are_seeded_barycentric_weights():
    a = tgenerator.dirichlet_draws(4, 50, seed=3)
    assert a.shape == (4, 50, 3) and (a > 0).all()
    torch.testing.assert_close(a.sum(-1), torch.ones(4, 50))
    assert torch.equal(a, tgenerator.dirichlet_draws(4, 50, seed=3))
    assert not torch.equal(a, tgenerator.dirichlet_draws(4, 50, seed=4))
