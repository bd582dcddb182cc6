"""Each module of the port's generation path (`rfdnet_tpu_torch.models`)
against its `rfdnet_tpu.models` counterpart on the CPU: one set of flax
variables (init + seeded noise) loaded into both, same numpy inputs.

Tolerances: index outputs (FPS sample indices) are exact; f32 outputs use
atol 3e-5, rtol 2e-4 (`tests/test_parity_torch.py:41-42`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.models import common as jcommon
from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu.models import occnet as joccnet
from rfdnet_tpu.models import pointnet2 as jpn2
from rfdnet_tpu.models import pointseg as jpointseg
from rfdnet_tpu.models import proposal as jproposal
from rfdnet_tpu.models import skip_propagation as jskip
from rfdnet_tpu.models import voting as jvoting
from rfdnet_tpu.models.backbone import Pointnet2Backbone as JaxBackbone
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch import weights
from rfdnet_tpu_torch.models import (
    MLPHead,
    PointSeg,
    Pointnet2Backbone,
    ProposalModule,
    ResnetPointnet,
    SetAbstraction,
    SharedMLP,
    SkipPropagation,
    STNGroup,
    FeaturePropagation,
    VotingModule,
    decode_scores,
    make_3d_grid,
)
from torch_parity import (
    apply_flax,
    assert_close,
    assert_equal,
    init_flax,
    load_port,
    scene,
    t,
)

RNG = np.random.RandomState(0)
X = RNG.randn(2, 50, 7).astype(np.float32)


@pytest.mark.parametrize("kind", ["shared_mlp", "mlp_head"])
def test_shared_mlp_and_mlp_head(kind):
    if kind == "shared_mlp":
        jm, tm = jcommon.SharedMLP([32, 16]), SharedMLP(7, [32, 16])
    else:
        jm, tm = jcommon.MLPHead([32, 16], 5), MLPHead(7, [32, 16], 5)
    vs = init_flax(jm, 0, jnp.asarray(X), False)
    assert_close(load_port(tm, vs)(t(X)), apply_flax(jm, vs, jnp.asarray(X), False))


def _xyz_feats(seed, N, C):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (2, N, 3)).astype(np.float32),
            rng.randn(2, N, C).astype(np.float32))


def test_set_abstraction():
    xyz, feats = _xyz_feats(1, 600, 5)
    jm = jpn2.SetAbstraction(npoint=64, radius=0.4, nsample=16,
                             mlp=[16, 32], normalize_xyz=True, fps_impl="xla")
    args = (jnp.asarray(xyz), jnp.asarray(feats), False)
    vs = init_flax(jm, 1, *args)
    w_xyz, w_feat, w_inds = apply_flax(jm, vs, *args)
    g_xyz, g_feat, g_inds = load_port(
        SetAbstraction(64, 0.4, 16, 5, [16, 32], normalize_xyz=True), vs
    )(t(xyz), t(feats))
    assert_equal(g_inds, w_inds)
    assert_equal(g_xyz, w_xyz)
    assert_close(g_feat, w_feat)


def test_feature_propagation():
    xyz, feats = _xyz_feats(2, 200, 6)
    kxyz, kfeats = _xyz_feats(3, 50, 9)
    jm = jpn2.FeaturePropagation(mlp=[16, 8])
    args = (jnp.asarray(xyz), jnp.asarray(kxyz), jnp.asarray(feats),
            jnp.asarray(kfeats), False)
    vs = init_flax(jm, 2, *args)
    got = load_port(FeaturePropagation(15, [16, 8]), vs)(
        t(xyz), t(kxyz), t(feats), t(kfeats))
    assert_close(got, apply_flax(jm, vs, *args))


def test_stn_group():
    xyz, feats = _xyz_feats(4, 800, 2)
    rng = np.random.RandomState(4)
    centers = xyz[:, :6] + rng.normal(0, 0.05, (2, 6, 3)).astype(np.float32)
    heading = rng.uniform(-3, 3, (2, 6)).astype(np.float32)
    jm = jpn2.STNGroup(radius=1.0, nsample=128)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(centers),
            jnp.asarray(heading), False)
    vs = init_flax(jm, 3, *args)
    w_xyz, w_feat = apply_flax(jm, vs, *args)
    g_xyz, g_feat = load_port(STNGroup(1.0, 128), vs)(
        t(xyz), t(feats), t(centers), t(heading))
    assert_equal(g_feat, w_feat)
    assert_close(g_xyz, w_xyz)


def test_pointseg():
    x = np.random.RandomState(5).randn(3, 64, 4).astype(np.float32)
    jm = jpointseg.PointSeg(num_class=2, channel=4)
    vs = init_flax(jm, 4, jnp.asarray(x), False)
    w_lp, w_tf = apply_flax(jm, vs, jnp.asarray(x), False)
    g_lp, g_tf = load_port(PointSeg(2, 4), vs)(t(x))
    assert_close(g_lp, w_lp)
    assert_close(g_tf, w_tf)


def test_resnet_pointnet():
    p = np.random.RandomState(6).randn(3, 40, 12).astype(np.float32)
    jm = jlayers.ResnetPointnet(c_dim=24, hidden_dim=16)
    vs = init_flax(jm, 5, jnp.asarray(p))
    got = load_port(ResnetPointnet(12, c_dim=24, hidden_dim=16), vs)(t(p))
    assert_close(got, apply_flax(jm, vs, jnp.asarray(p)))


def test_voting_and_proposal_heads():
    xyz, feats = _xyz_feats(7, 300, 256)
    jv = jvoting.VotingModule()
    vs = init_flax(jv, 6, jnp.asarray(xyz), jnp.asarray(feats), False)
    w_vxyz, w_vf = apply_flax(jv, vs, jnp.asarray(xyz), jnp.asarray(feats),
                              False)
    g_vxyz, g_vf = load_port(VotingModule(), vs)(t(xyz), t(feats))
    assert_close(g_vxyz, w_vxyz)
    assert_close(g_vf, w_vf)

    jp = jproposal.ProposalModule(num_proposal=32, fps_impl="xla")
    ep = {"seed_xyz": jnp.asarray(xyz)}
    args = (jnp.asarray(xyz), jnp.asarray(feats), ep, False)
    vs = init_flax(jp, 7, *args)
    w_out, w_pf = apply_flax(jp, vs, *args)
    g_out, g_pf = load_port(ProposalModule(num_proposal=32), vs)(
        t(xyz), t(feats), {"seed_xyz": t(xyz)})
    assert_equal(g_out["aggregated_vote_inds"], w_out["aggregated_vote_inds"])
    assert_close(g_pf, w_pf)
    for k, v in w_out.items():
        if k != "aggregated_vote_inds":
            assert_close(g_out[k], v, what=k)

    net = np.random.RandomState(8).randn(2, 16, 69).astype(np.float32)
    w_dec = jproposal.decode_scores(jnp.asarray(net), jnp.asarray(xyz[:, :16]),
                                    12, 8)
    g_dec = decode_scores(t(net), t(xyz[:, :16]), 12, 8)
    assert set(g_dec) == set(w_dec)
    for k, v in w_dec.items():
        assert_equal(g_dec[k], v, what=k)


def test_backbone():
    pc = scene(9, num_points=2500)
    jm = JaxBackbone(fps_impl="xla")
    vs = init_flax(jm, 8, jnp.asarray(pc), False)
    want = apply_flax(jm, vs, jnp.asarray(pc), False)
    got = load_port(Pointnet2Backbone(1), vs)(t(pc))
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_inds"):
            assert_equal(got[k], v, what=k)
        else:
            assert_close(got[k], v, what=k)


def test_skip_propagation_generate():
    pc = scene(10, num_points=2048)
    rng = np.random.RandomState(10)
    centers = pc[:, :4, :3] + rng.normal(0, 0.1, (1, 4, 3)).astype(np.float32)
    heading = rng.uniform(-3, 3, (1, 4)).astype(np.float32)
    box_feat = rng.randn(1, 4, 128).astype(np.float32)
    jm = jskip.SkipPropagation()
    args = tuple(jnp.asarray(a) for a in (centers, heading, box_feat, pc))
    vs = init_flax(jm, 9, *args, method=jskip.SkipPropagation.generate)
    want = apply_flax(jm, vs, *args, method=jskip.SkipPropagation.generate)
    got = load_port(SkipPropagation(), vs).generate(
        t(centers), t(heading), t(box_feat), t(pc))
    assert_close(got, want)


def test_make_3d_grid_matches_jax():
    """torch.linspace and jnp.linspace round differently: within 1 ULP."""
    for n in (8, 32):
        want = joccnet.make_3d_grid((-0.5,) * 3, (0.5,) * 3, (n,) * 3)
        got = make_3d_grid((-0.5,) * 3, (0.5,) * 3, (n,) * 3)
        assert got.shape == want.shape
        assert_close(got, want, atol=6e-8, rtol=0)


def test_init_seeded_is_deterministic_and_perturbs_zero_layers():
    a = weights.init_seeded(tconfig.build_model(device="cpu"), 3)
    b = weights.init_seeded(tconfig.build_model(device="cpu"), 3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    fc1 = a.completion.decoder.block0.fc_1.weight
    assert 0.01 < fc1.std() < 0.03  # zero init + N(0, 0.02^2)
    gamma = a.completion.decoder.block0.bn_0.gamma.bias
    assert (gamma - 1).abs().max() < 0.2  # identity CBN + noise
