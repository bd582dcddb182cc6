"""The parts of the JAX package that no shipped config selects, ported and
held against `rfdnet_tpu` on the CPU: `SetAbstractionMSG`,
`SelfAttention`, the BoxNet detection loss, `chamfer_loss` and the
registry (the bf16 chains of `data.mlp_bf16`: `test_torch_mlp_bf16.py`).

Tolerances:
- indices (FPS samples) and registry names: exact;
- f32 outputs, losses and gradients: atol 3e-5, rtol 2e-4
  (`tests/test_parity_torch.py:41-42`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu import registry as jregistry
from rfdnet_tpu.config.scannet import ScannetConfig
from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu.models import losses as jlosses
from rfdnet_tpu.models import pointnet2 as jpn2
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch import registry, weights
from rfdnet_tpu_torch.models import losses as tlosses
from rfdnet_tpu_torch.models import SelfAttention, SetAbstractionMSG
from test_torch_train import _detection_inputs
from torch_parity import (
    apply_flax,
    assert_close,
    assert_equal,
    init_flax,
    load_port,
    t,
    torch_batch,
)


def test_set_abstraction_msg_matches_jax():
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-1, 1, (2, 700, 3)).astype(np.float32)
    feats = rng.randn(2, 700, 4).astype(np.float32)
    jm = jpn2.SetAbstractionMSG(npoint=64, radii=(0.2, 0.4),
                                nsamples=(8, 16), mlps=((8, 16), (16, 24)),
                                fps_impl="xla")
    args = (jnp.asarray(xyz), jnp.asarray(feats), False)
    vs = init_flax(jm, 2, *args)
    w_xyz, w_feat, w_inds = apply_flax(jm, vs, *args)
    port = load_port(SetAbstractionMSG(64, (0.2, 0.4), (8, 16), 4,
                                       ((8, 16), (16, 24))), vs)
    g_xyz, g_feat, g_inds = port(t(xyz), t(feats))
    assert g_feat.shape == (2, 64, 40)
    assert_equal(g_inds, w_inds)
    assert_equal(g_xyz, w_xyz)
    assert_close(g_feat, w_feat)
    # the flax names round-trip through the port's flat layout
    flat = weights.flax_flat(port)
    assert "params/mlp1/dense0/kernel" in flat
    with pytest.raises(ValueError, match="branch"):
        SetAbstractionMSG(64, (0.2,), (8, 16), 4, ((8,), (8,)))


def test_self_attention_matches_jax():
    x = np.random.RandomState(2).randn(2, 30, 32).astype(np.float32) * 3
    jm = jlayers.SelfAttention(reduce=8)
    vs = init_flax(jm, 3, jnp.asarray(x))   # gamma perturbed off zero
    want = apply_flax(jm, vs, jnp.asarray(x))
    port = load_port(SelfAttention(32, reduce=8), vs)
    assert float(port.gamma) != 0.0
    assert_close(port(t(x)), want)
    flat = weights.flax_flat(port)
    assert sorted(flat) == sorted(
        ["params/gamma"] + [f"params/{m}/{p}" for m in ("key", "query",
                                                        "value")
                            for p in ("bias", "kernel")])
    fresh = weights.init_seeded(SelfAttention(32), 0, noise=0.0)
    assert float(fresh.gamma) == 0.0
    assert torch.equal(fresh(t(x)), t(x))


def test_boxnet_detection_loss_matches_jax():
    """Every term, and the gradient of the total with respect to every
    float end point."""
    est, gt = _detection_inputs(5)
    K = est["objectness_scores"].shape[1]
    est["aggregated_vote_inds"] = np.random.RandomState(5).randint(
        0, est["seed_xyz"].shape[1], (2, K)).astype(np.int32)
    dc = ScannetConfig()
    jest = {k: jnp.asarray(v) for k, v in est.items()}
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    want = jlosses.boxnet_detection_loss(jest, jgt, dc)
    test = {k: t(v).requires_grad_(v.dtype == np.float32)
            for k, v in est.items()}
    got = tlosses.boxnet_detection_loss(test, torch_batch(gt),
                                        tconfig.MEAN_SIZE_ARR)
    assert set(got) == set(want) and "vote_loss" not in got
    assert 0 < float(want["pos_ratio"]) < 1
    for k in want:
        assert_close(got[k], want[k], what=k)
    floats = [k for k, v in est.items() if v.dtype == np.float32]
    jgrad = jax.grad(lambda e: jlosses.boxnet_detection_loss(
        {**jest, **e}, jgt, dc)["total"])({k: jest[k] for k in floats})
    got["total"].backward()
    for k in floats:
        grad = test[k].grad if test[k].grad is not None else torch.zeros(
            est[k].shape)
        assert_close(grad, jgrad[k], what=k)


def test_chamfer_loss_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.randn(2, 40, 3).astype(np.float32)
    b = rng.randn(2, 25, 3).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda a: jlosses.chamfer_loss(a, jnp.asarray(b), 0.5))(
        jnp.asarray(a))
    ta = t(a).requires_grad_(True)
    got = tlosses.chamfer_loss(ta, t(b), 0.5)
    assert_close(got, want)
    got.backward()
    assert_close(ta.grad, jgrad)


def test_registry_names_match_jax():
    for ours, theirs in ((registry.METHODS, jregistry.METHODS),
                         (registry.MODULES, jregistry.MODULES),
                         (registry.LOSSES, jregistry.LOSSES)):
        assert sorted(ours._map) == sorted(theirs._map)
        for name in theirs._map:
            assert ours.get(name).__name__ == theirs.get(name).__name__
    assert registry.LOSSES.get("BoxNetDetectionLoss") is (
        tlosses.boxnet_detection_loss)
    with pytest.raises(KeyError, match="known"):
        registry.MODULES.get("Nope")
