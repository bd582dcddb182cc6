"""The Tester path of the port against `rfdnet_tpu`'s, on the CPU: the
posterior encoder, the eval completion loss with the 16^3 shape voxels,
the PointSeg mask loss, the supervised skip propagation, `ISCNet.generate`
with GT fields and the demo's box refit (`Tester.run`, the CLI in test
mode and the grid downloads: `tests/test_torch_tester_run.py`).

The models come from one set of flax variables (`torch_parity`), at the
test config's widths with 8 generated slots and 4096 scene points; the
JAX package runs its decoder through the flax chain, the port through
`cbn_decode_plain` (the CUDA kernel's plain version).

Tolerances:
- index outputs (proposal ids with their GT ids and classes, valid
  flags, NMS masks) are exact;
- f32 outputs (posterior mean and log-std, KL, BCE and completion loss,
  mask loss, features) use atol 3e-5, rtol 2e-4
  (`tests/test_parity_torch.py:41-42`);
- shape-voxel bits are equal wherever the voxel's logit is more than 1e-4
  from the iso level (the two decodes differ by ~1e-7 and a logit that
  close to 0 may round to either side);
- the demo's refit corners: within 1e-3 of JAX `fit_meshes_to_scan` run
  on the port's own meshes (see `tests/test_torch_eval.py`), and the JAX
  demo's own meshes (from the same grids within 1e-7) only where they
  are comparable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu import demo as jdemo
from rfdnet_tpu.config.config import Config
from rfdnet_tpu.eval import refit as jrefit
from rfdnet_tpu.meshing.mesh import TriMesh as JTriMesh
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu.models import occnet as jocc
from rfdnet_tpu.models import pointseg as jpointseg
from rfdnet_tpu.models import skip_propagation as jskip
from rfdnet_tpu_torch import demo
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.data.synthetic import synthetic_scene_batch
from rfdnet_tpu_torch.models import occnet
from rfdnet_tpu_torch.models.layers import EncoderLatent
from rfdnet_tpu_torch.models.occnet import ONet, make_3d_grid
from rfdnet_tpu_torch.models.pointseg import pointseg_loss
from rfdnet_tpu_torch.models.skip_propagation import SkipPropagation
from torch_parity import (
    TEST_YAML,
    apply_flax,
    assert_close,
    assert_equal,
    init_flax,
    iscnet_pair,
    load_port,
    t,
)

LOW = 0.05  # a dump threshold that keeps valid slots with these weights
TINY = {"seed": 0, "weight": [], "data": {"num_point": 4096},
        "generation": {"dump_threshold": LOW}}


def assert_bits_equal_away_from_iso(bits, want_bits, logits, margin=1e-4):
    """Packed voxel bits equal wherever |logit| > margin."""
    got = np.unpackbits(np.asarray(bits), axis=-1).astype(bool)
    want = np.unpackbits(np.asarray(want_bits), axis=-1).astype(bool)
    far = np.abs(np.asarray(logits)).reshape(got.shape) > margin
    assert far.mean() > 0.99
    assert_equal(got[far], want[far])


# --------------------------------------------------------------- modules
def test_encoder_latent_matches_jax():
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.55, 0.55, (3, 300, 3)).astype(np.float32)
    occ = (rng.rand(3, 300) > 0.5).astype(np.float32)
    c = rng.randn(3, 40).astype(np.float32)
    jm = jlayers.EncoderLatent(z_dim=6)
    vs = init_flax(jm, 0, *(jnp.asarray(a) for a in (p, occ, c)))
    want = apply_flax(jm, vs, *(jnp.asarray(a) for a in (p, occ, c)))
    got = load_port(EncoderLatent(c_dim=40, z_dim=6), vs)(t(p), t(occ), t(c))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_compute_loss_and_its_terms_match_jax():
    """`ONet.compute_loss` (posterior-mean z, KL summed over z, BCE summed
    over points, mean over the valid objects) and its shape voxels; the
    port decodes through `decode_fused`, the JAX package through the flax
    chain."""
    rng = np.random.RandomState(1)
    Nb, T = 5, 512
    feats = rng.randn(Nb, 512).astype(np.float32)
    pts = rng.uniform(-0.55, 0.55, (Nb, T, 3)).astype(np.float32)
    occ = (np.abs(pts).max(-1) < 0.4).astype(np.float32)
    cls = np.eye(8, dtype=np.float32)[rng.randint(0, 8, Nb)]
    valid = np.array([1, 1, 0, 1, 0], bool)
    jm = jocc.ONet()
    args = [jnp.asarray(a) for a in (feats, pts, occ, cls)]
    vs = init_flax(jm, 2, *args, None, False, method=jocc.ONet.compute_loss,
                   export_shape=True)
    port = load_port(ONet(), vs)
    for mask in (valid, None):
        want_loss, want_vox = apply_flax(
            jm, vs, *args, None, False, method=jocc.ONet.compute_loss,
            export_shape=True,
            valid_mask=None if mask is None else jnp.asarray(mask))
        got_loss, got_vox = port.compute_loss(
            t(feats), t(pts), t(occ), t(cls), export_shape=True,
            valid_mask=None if mask is None else t(mask))
        assert_close(got_loss, want_loss)
    p16 = make_3d_grid([-0.5 + 1 / 32] * 3, [0.5 - 1 / 32] * 3, (16,) * 3)
    logits = port.decode_fused(p16[None].expand(Nb, -1, -1),
                               torch.zeros(Nb, 32), t(feats))
    pack = lambda v: np.packbits(np.asarray(v).reshape(Nb, -1), axis=-1)
    assert_bits_equal_away_from_iso(pack(got_vox), pack(want_vox), logits)
    # the terms
    want_z = apply_flax(jm, vs, *args[1:3], args[0], method=jocc.ONet.infer_z)
    got_z = port.infer_z(t(pts), t(occ), t(feats))
    for g, w in zip(got_z, want_z):
        assert_close(g, w)
    x = rng.randn(4, 300).astype(np.float32) * 8
    y = (rng.rand(4, 300) > 0.5).astype(np.float32)
    assert_close(occnet._bce_with_logits(t(x), t(y)),
                 jocc._bce_with_logits(jnp.asarray(x), jnp.asarray(y)))


def test_pointseg_loss_matches_jax():
    rng = np.random.RandomState(3)
    M, B = 600, 6
    logits = rng.randn(M, 2).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rng.randint(0, 2, M)
    trans = (np.eye(64) + 0.1 * rng.randn(B, 64, 64)).astype(np.float32)
    w = (rng.rand(B) > 0.4).astype(np.float32)
    for kw in ({}, {"sample_weights": np.repeat(w, M // B),
                    "trans_weights": w}):
        want = jpointseg.pointseg_loss(
            jnp.asarray(log_probs), jnp.asarray(target), jnp.asarray(trans),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = pointseg_loss(t(log_probs), t(target), t(trans),
                            **{k: t(v) for k, v in kw.items()})
        assert_close(got, want)


def test_supervised_skip_propagation_matches_jax():
    rng = np.random.RandomState(4)
    B, P, N = 2, 3, 2048
    pc = rng.uniform(-1.5, 1.5, (B, N, 4)).astype(np.float32)
    labels = rng.randint(0, 4, (B, N)).astype(np.float32)
    args = [jnp.asarray(a) for a in (
        rng.uniform(-1, 1, (B, P, 3)).astype(np.float32),
        rng.uniform(-3, 3, (B, P)).astype(np.float32),
        rng.randn(B, P, 128).astype(np.float32), pc, labels,
        rng.randint(0, 4, (B, P)).astype(np.float32))]
    slot_mask = np.array([[1, 1, 0], [1, 0, 0]], bool)
    jm = jskip.SkipPropagation()
    vs = init_flax(jm, 9, *args, False)
    port = load_port(SkipPropagation(), vs)
    for mask in (slot_mask, None):
        want_f, want_loss = apply_flax(
            jm, vs, *args, False,
            slot_mask=None if mask is None else jnp.asarray(mask))
        got_f, got_loss = port(*(t(np.asarray(a)) for a in args),
                               slot_mask=None if mask is None else t(mask))
        assert_close(got_f, want_f)
        assert_close(got_loss, want_loss)
    # generate is the unsupervised forward of the same module
    assert_close(port.generate(*(t(np.asarray(a)) for a in args[:4])),
                 apply_flax(jm, vs, *args[:4],
                            method=jskip.SkipPropagation.generate))


# ------------------------------------------------------ generate with GT
@pytest.fixture(scope="module")
def pair():
    return iscnet_pair(generate_limit=8)


@pytest.fixture(scope="module")
def gt_scene():
    return synthetic_scene_batch(
        np.random.RandomState(1), batch_size=1, num_points=4096,
        num_objects=5, num_obj_points=2048,
        mean_size_arr=tconfig.MEAN_SIZE_ARR)


def test_generate_with_gt_fields_matches_jax(pair, gt_scene):
    model, variables, port = pair
    keys = ("point_clouds", "center_label", "box_label_mask", "sem_cls_label",
            "point_instance_labels", "object_instance_labels",
            "object_points", "object_points_occ")
    data = {k: gt_scene[k] for k in keys}
    # a dump threshold in the widest gap between the 3rd and the 7th
    # eligible objectness (objectness is flat with these weights; the
    # packages differ by ~1e-7), so that 2-5 of the 8 slots are padding,
    # which the losses must leave out
    parsed = port.generate({"point_clouds": t(data["point_clouds"])},
                           remove_empty_box=True)["parsed"]
    probs = torch.sort(parsed["obj_prob"][parsed["pred_mask"]],
                       descending=True).values.double()
    k = 2 + int(torch.argmax(probs[2:7] - probs[3:8]))
    assert probs[k] - probs[k + 1] > 1e-6
    threshold = float(probs[k] + probs[k + 1]) / 2
    want = jax.jit(lambda v, d: model.apply(
        v, d, method=ISCNet.generate, dump_threshold=threshold,
        remove_empty_box=True))(variables, data)
    got = port.generate({k: t(v) for k, v in data.items()},
                        dump_threshold=threshold, remove_empty_box=True)
    assert_equal(got["parsed"]["pred_mask"], want["parsed"]["pred_mask"])
    gen, w_gen = got["gen"], want["gen"]
    assert_equal(gen["proposal_ids"], w_gen["proposal_ids"])
    assert_equal(gen["valid"], w_gen["valid"])
    assert int(gen["valid"].sum()) == k + 1
    gt_ids = gen["proposal_ids"][0, :, 1]
    assert (gt_ids < 5).all() and len(set(gt_ids.tolist())) > 1
    for k in ("features", "cls_codes", "mask_loss"):
        assert_close(gen[k], w_gen[k], what=k)
    assert_close(got["completion_loss"], want["completion_loss"])
    assert got["shape_voxels_bits"].dtype == torch.uint8
    assert tuple(got["shape_voxels_bits"].shape) == (8, 512)
    p16 = make_3d_grid([-0.5 + 1 / 32] * 3, [0.5 - 1 / 32] * 3, (16,) * 3)
    logits = port.decode_occupancy(gen["features"], gen["cls_codes"],
                                   p16[None].expand(8, -1, -1))
    assert_bits_equal_away_from_iso(got["shape_voxels_bits"],
                                    want["shape_voxels_bits"], logits)
    # all GT boxes masked: every proposal is assigned GT 0
    masked = dict(data, box_label_mask=np.zeros_like(data["box_label_mask"]))
    out = port.generate({k: t(v) for k, v in masked.items()},
                        dump_threshold=threshold, export_voxels=False)
    assert (out["gen"]["proposal_ids"][..., 1] == 0).all()
    assert "shape_voxels_bits" not in out


# ------------------------------------------------------------------ demo
def test_demo_post_processing_matches_jax(pair, gt_scene):
    model, variables, port = pair
    jcfg = Config(TEST_YAML, mode="demo", make_dirs=False)
    cfg = tconfig.load_config(TEST_YAML, mode="demo")
    over = {"generation": {"resolution_0": 8, "dump_threshold": LOW}}
    tconfig.update_recursive(jcfg.config, over)
    tconfig.update_recursive(cfg, over)
    pc = gt_scene["point_clouds"]
    parsed, gen, meshes = demo.generate(cfg, port, {"point_clouds": t(pc)},
                                        post_processing=True)
    plain, _, _ = demo.generate(cfg, port, {"point_clouds": t(pc)})
    moved = np.abs(parsed["pred_corners_3d_upright_camera"]
                   - plain["pred_corners_3d_upright_camera"]).max(axis=(2, 3))
    # only the boxes of valid slots move (a box with fewer than 5 scene
    # points in it stays)
    selected = np.isin(np.arange(moved.shape[1]),
                       gen["proposal_ids"][0, gen["valid"][0], 0])
    assert (moved[0] > 1e-6).sum() > 0 and not (moved[0] > 1e-6)[~selected].any()
    # the JAX refit on the port's own meshes
    want = jrefit.fit_meshes_to_scan(
        dict(plain), [JTriMesh(m.vertices, m.faces) for m in meshes],
        gen["proposal_ids"], gen["valid"], pc, LOW)
    assert_close(parsed["pred_corners_3d_upright_camera"],
                 want["pred_corners_3d_upright_camera"], atol=1e-3, rtol=0)
    # the JAX demo end to end: same boxes refit from its own meshes
    w_parsed, w_gen, w_meshes = jdemo.generate(
        jcfg, model, variables, {"point_clouds": pc}, post_processing=True)
    assert_equal(w_gen["proposal_ids"], gen["proposal_ids"])
    same = all(np.array_equal(a.faces, b.faces)
               for a, b in zip(meshes, w_meshes))
    print(f"meshes of both demos equal: {same}")
    if same:
        assert_close(parsed["pred_corners_3d_upright_camera"],
                     w_parsed["pred_corners_3d_upright_camera"], atol=1e-3,
                     rtol=0)


def test_weights_carry_the_posterior_encoder(pair, tmp_path):
    """`from_flax` and `load_npz` load the encoder's flax variables by name;
    `init_seeded` fills it after the rest, so the generation path's seeded
    values are those of a model without it."""
    from rfdnet_tpu_torch import weights

    _, variables, port = pair
    flat = {}
    for k, v in variables["params"]["completion"]["encoder_latent"].items():
        for leaf, a in v.items():
            flat[f"params/completion/encoder_latent/{k}/{leaf}"] = a
    assert len(flat) == 16
    np.savez(str(tmp_path / "enc.npz"), **flat)
    fresh = tconfig.build_model(generate_limit=8, device="cpu")
    weights.init_seeded(fresh, 3)
    weights.load_npz(fresh, str(tmp_path / "enc.npz"), log=None)
    for k, v in port.state_dict().items():
        if ".encoder_latent." in k:
            assert torch.equal(fresh.state_dict()[k], v), k
    seeded = weights.init_seeded(
        tconfig.build_model(generate_limit=8, device="cpu"), 3)
    without = tconfig.build_model(generate_limit=8, device="cpu")
    del without.completion.encoder_latent
    weights.init_seeded(without, 3)
    state = seeded.state_dict()
    for k, v in without.state_dict().items():
        assert torch.equal(state[k], v), k
    enc = seeded.completion.encoder_latent.fc_mean.weight
    assert enc.abs().max() > 0 and not torch.equal(
        enc, weights.init_seeded(tconfig.build_model(
            generate_limit=8, device="cpu"), 4).completion.encoder_latent
        .fc_mean.weight)
