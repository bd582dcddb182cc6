"""The bf16 MLP chains of `data.mlp_bf16`, which no shipped config
selects, held against `rfdnet_tpu`'s on the CPU: the backbone, voting,
proposal and skip-propagation modules, each on its own inputs, and the
model that the key builds.

Tolerances:
- indices (FPS samples): exact;
- bf16 chains (backbone features, votes, proposal heads, skip-propagation
  codes): within 2e-2 x max(|JAX's|, 1) of JAX's bf16 output (the bf16
  decode's tolerance, `tests/test_cbn_decoder.py:80`: bf16 keeps 8 bits,
  and summing in another order can flip a rounding that later layers
  carry); and the port's output stands off JAX's f32 one by at least half
  the mean distance of JAX's bf16 output from it (the chain really ran in
  bf16). Argmaxes and NMS keeps are not compared.
"""

import jax.numpy as jnp
import numpy as np
import torch

from rfdnet_tpu.models import proposal as jproposal
from rfdnet_tpu.models import skip_propagation as jskip
from rfdnet_tpu.models import voting as jvoting
from rfdnet_tpu.models.backbone import Pointnet2Backbone as JaxBackbone
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.models import (
    Pointnet2Backbone,
    ProposalModule,
    SkipPropagation,
    VotingModule,
)
from rfdnet_tpu_torch.models.common import set_compute_dtype
from torch_parity import apply_flax, assert_equal, init_flax, load_port, scene, t

BF16_TOL = 2e-2


def _bf16_close(got, want_bf16, want_f32, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want_bf16, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= BF16_TOL * scale, (what, err, scale)
    f32 = np.asarray(want_f32, np.float32)
    off = float(np.abs(got - f32).mean())
    assert off >= 0.5 * float(np.abs(want - f32).mean()) > 0, what


def _both(jclass, kwargs, seed, *args, method=None):
    """(variables, JAX bf16 output, JAX f32 output) of a flax module."""
    jm = jclass(mlp_dtype="bfloat16", **kwargs)
    extra = {} if method is None else {"method": method}
    vs = init_flax(jm, seed, *args, **extra)
    method16 = {} if method is None else {"method": getattr(jm, method.__name__)}
    want16 = apply_flax(jm, vs, *args, **method16)
    jm32 = jclass(**kwargs)
    method32 = {} if method is None else {"method": getattr(jm32, method.__name__)}
    want32 = apply_flax(jm32, vs, *args, **method32)
    return vs, want16, want32


def _bf16_port(module, vs):
    port = load_port(module, vs)
    set_compute_dtype(port, torch.bfloat16)
    return port


def test_bf16_backbone_matches_jax():
    pc = scene(9, num_points=2500)
    vs, w16, w32 = _both(JaxBackbone, {"fps_impl": "xla"}, 8,
                         jnp.asarray(pc), False)
    got = _bf16_port(Pointnet2Backbone(1), vs)(t(pc))
    for k, v in w16.items():
        if k.endswith("_inds"):
            assert_equal(got[k], v, what=k)
        elif k.endswith("_features"):
            assert got[k].dtype == torch.float32, k
            _bf16_close(got[k], v, w32[k], what=k)


def test_bf16_voting_and_proposal_match_jax():
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    feats = rng.randn(2, 300, 256).astype(np.float32)
    vs, w16, w32 = _both(jvoting.VotingModule, {}, 6, jnp.asarray(xyz),
                         jnp.asarray(feats), False)
    port = _bf16_port(VotingModule(), vs)
    assert port.conv1.compute_dtype is torch.bfloat16
    assert port.conv3.compute_dtype is None
    g_xyz, g_f = port(t(xyz), t(feats))
    _bf16_close(g_xyz, w16[0], w32[0], "vote_xyz")
    _bf16_close(g_f, w16[1], w32[1], "vote_features")

    ep = {"seed_xyz": jnp.asarray(xyz)}
    vs, (w16, wpf16), (w32, wpf32) = _both(
        jproposal.ProposalModule, {"num_proposal": 32, "fps_impl": "xla"},
        7, jnp.asarray(xyz), jnp.asarray(feats), ep, False)
    port = load_port(ProposalModule(num_proposal=32), vs)
    set_compute_dtype(port.vote_aggregation, torch.bfloat16)
    g_out, g_pf = port(t(xyz), t(feats), {"seed_xyz": t(xyz)})
    assert_equal(g_out["aggregated_vote_inds"], w16["aggregated_vote_inds"])
    _bf16_close(g_pf, wpf16, wpf32, "proposal_features")
    for k in ("objectness_scores", "center", "heading_scores",
              "size_residuals_normalized", "sem_cls_scores"):
        _bf16_close(g_out[k], w16[k], w32[k], what=k)


def test_bf16_skip_propagation_matches_jax():
    pc = scene(10, num_points=2048)
    rng = np.random.RandomState(10)
    centers = pc[:, :4, :3] + rng.normal(0, 0.1, (1, 4, 3)).astype(np.float32)
    heading = rng.uniform(-3, 3, (1, 4)).astype(np.float32)
    box_feat = rng.randn(1, 4, 128).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (centers, heading, box_feat, pc))
    vs, w16, w32 = _both(jskip.SkipPropagation, {}, 9, *args,
                         method=jskip.SkipPropagation.generate)
    port = _bf16_port(SkipPropagation(), vs)
    heads = {n for n, m in port.named_modules()
             if getattr(m, "compute_dtype", False) is None}
    assert {"encoder.fc_c", "point_seg.conv4", "point_seg.feat.stn.fc3",
            "stn.stn3d.fc1"} <= heads
    got = port.generate(t(centers), t(heading), t(box_feat), t(pc))
    assert got.dtype == torch.float32
    _bf16_close(got, w16, w32, "features")


def test_mlp_bf16_config_builds_bf16_chains():
    cfg = tconfig.load_config(None, mode="test")
    cfg["data"]["mlp_bf16"] = True
    model = tconfig.build_model(cfg, generate_limit=8, device="cpu")
    assert model.backbone.sa1.mlp.dense0.compute_dtype is torch.bfloat16
    assert model.voting.conv3.compute_dtype is None
    assert model.detection.conv1.compute_dtype is None
    assert (model.detection.vote_aggregation.mlp.dense0.compute_dtype
            is torch.bfloat16)
    assert model.completion.decoder.fc_p.compute_dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_low_precision_product_and_its_derivatives_match_jax():
    """`common.low_precision_product` (the bf16 `Dense`'s product) against
    JAX's bf16 dot with an f32 result: the product, its gradients (f32
    products rounded to bf16, within one bf16 rounding: the two sum in
    other orders) and a second derivative, as refinement takes it."""
    import jax

    from rfdnet_tpu_torch.models.common import low_precision_product

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 8)).astype(np.float32)  # flax (in, out)
    c = rng.standard_normal((2, 5, 8)).astype(np.float32)

    def jprod(x, w):
        return jnp.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)

    def jgrad_norm(x, w):
        gx = jax.grad(lambda x: jnp.sum(c * jprod(x, w)))(x)
        return jnp.sum(gx * gx)

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w.T.copy(), requires_grad=True)
    y = low_precision_product(tx.to(torch.bfloat16), tw.to(torch.bfloat16))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jprod(x, w)),
                               rtol=1e-6, atol=1e-6)
    gx, gw = torch.autograd.grad((y * torch.tensor(c)).sum(), (tx, tw),
                                 create_graph=True)
    jgx, jgw = jax.grad(lambda x, w: jnp.sum(c * jprod(x, w)),
                        argnums=(0, 1))(x, w)
    np.testing.assert_allclose(gx.detach().numpy(), np.asarray(jgx),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(gw.detach().numpy(), np.asarray(jgw).T,
                               rtol=1e-2, atol=1e-6)
    ggw, = torch.autograd.grad((gx * gx).sum(), tw)
    np.testing.assert_allclose(ggw.numpy(),
                               np.asarray(jax.grad(jgrad_norm, 1)(x, w)).T,
                               rtol=2e-2, atol=1e-5)
