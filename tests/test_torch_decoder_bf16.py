"""`data.decoder_bf16` and `generation.decoder_impl` in the port, on the CPU.

- The layer-by-layer decoder at `compute_dtype=torch.bfloat16` against the
  JAX package's `DecoderCBatchNorm(compute_dtype="bfloat16")`, from one set
  of flax variables (`torch_parity.init_flax`) and numpy inputs made from
  a seed, in eval and in train mode. The two chains round to bf16 at the
  same layers (each bf16 matmul once, after its f32 bias, in both) but
  not always at the same points (XLA may keep an elementwise result in
  f32 where torch rounds it), and sum their products in other orders, so
  the logits are held to
  2e-2 x max(scale, 1) with occupancy signs that agree except on logits
  within 1e-2 x scale of 0 (the tolerance of `tests/test_cbn_decoder.py`),
  and must sit nearer JAX's bf16 chain than its f32 one. The running
  statistics of a train-mode call are f32 in both (statistics of the bf16
  activations taken in f32): block0's, whose inputs agree but for rare
  flips, at the f32 tolerance of a module's train-mode call (atol 3e-5,
  rtol 2e-4, `tests/test_torch_train.py`), the later ones at the f32
  train step's (`torch_parity.STEP_STATS_ATOL` / `STEP_STATS_RTOL`):
  from block1 on, a batch statistic that the two packages sum in another
  order can round its channel's bf16 scale the other way, and the chains
  then differ by an ulp in most values (read here: the running
  statistics 1e-5 to 7e-4 apart).
- `ISCNet.gradient_decoder` of a `decoder_bf16` model runs the bf16 chain
  and gives finite gradients with respect to the points.
- The bf16 kernel's weight slabs (`ops.cbn_decoder.bf16_weight_image`)
  read back through the kernel's shared-memory addressing.
- The Tester's decode choice: with `generation.decoder_impl: pallas` the
  grid decode (and the MISE level decodes) take bf16 operands while the
  completion loss and the 16^3 voxels keep the decoder's type; None and
  "flax" leave every decode in the decoder's type.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch import weights
from rfdnet_tpu_torch.data.synthetic import synthetic_scene_batch
from rfdnet_tpu_torch.eval import tester
from rfdnet_tpu_torch.models import layers as tlayers
from rfdnet_tpu_torch.models import occnet
from rfdnet_tpu_torch.ops import cbn_decoder as tcbn
from torch_parity import (
    STEP_STATS_ATOL,
    STEP_STATS_RTOL,
    TEST_YAML,
    apply_flax,
    assert_close,
    init_flax,
    t,
)

NB, T, CD, ZD = 3, 256, 64, 8


@pytest.fixture(scope="module")
def chains():
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.55, 0.55, (NB, T, 3)).astype(np.float32)
    z = rng.randn(NB, ZD).astype(np.float32)
    c = (rng.randn(NB, CD) * 0.5).astype(np.float32)
    jbf = jlayers.DecoderCBatchNorm(z_dim=ZD, compute_dtype="bfloat16")
    jf32 = jlayers.DecoderCBatchNorm(z_dim=ZD)
    args = tuple(jnp.asarray(a) for a in (p, z, c))
    variables = init_flax(jf32, 0, *args, False)
    port = tlayers.DecoderCBatchNorm(c_dim=CD, z_dim=ZD,
                                     compute_dtype=torch.bfloat16)
    port.load_state_dict(weights.from_flax(variables))
    return dict(jbf=jbf, jf32=jf32, variables=variables, port=port,
                args=args, torch_args=(t(p), t(z), t(c)))


def _assert_bf16_close(got, want):
    got = got.detach().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err < 2e-2 * scale, (err, scale)
    near = np.abs(want) < 1e-2 * scale
    assert (((got >= 0) == (want >= 0)) | near).all()
    return err


def test_bf16_chain_matches_jax_in_eval_mode(chains):
    port = chains["port"].eval()
    with torch.no_grad():
        got = port(*chains["torch_args"])
    assert got.dtype == torch.float32
    want = np.asarray(apply_flax(chains["jbf"], chains["variables"],
                                 *chains["args"], False))
    err = _assert_bf16_close(got, want)
    # the roundings were made: nearer JAX's bf16 chain than its f32 one
    f32 = np.asarray(apply_flax(chains["jf32"], chains["variables"],
                                *chains["args"], False))
    assert err < float(np.abs(got.numpy() - f32).max())


def test_bf16_chain_matches_jax_in_train_mode(chains):
    """Batch statistics of the bf16 activations, in f32, and the running
    statistics they update (momentum 0.1 in both)."""
    port = tlayers.DecoderCBatchNorm(c_dim=CD, z_dim=ZD,
                                     compute_dtype=torch.bfloat16)
    port.load_state_dict(weights.from_flax(chains["variables"]))
    port.train()
    seen = []
    hook = port.block1.fc_0.register_forward_hook(
        lambda m, inp, out: seen.append((inp[0].dtype, out.dtype)))
    got = port(*chains["torch_args"])
    hook.remove()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    want, upd = apply_flax(chains["jbf"], chains["variables"],
                           *chains["args"], True, mutable=["batch_stats"])
    _assert_bf16_close(got, np.asarray(want))
    stats = weights.from_flax({"params": chains["variables"]["params"],
                               "batch_stats": upd["batch_stats"]})
    state = port.state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 11
    for k in names:
        assert state[k].dtype == torch.float32
        if k.startswith("block0."):
            assert_close(state[k], stats[k], what=k)
        else:
            assert_close(state[k], stats[k], atol=STEP_STATS_ATOL,
                         rtol=STEP_STATS_RTOL, what=k)
    # gradients flow through the bf16 chain
    got.float().sum().backward()
    g = port.block4.fc_1.weight.grad
    assert g is not None and bool(torch.isfinite(g).all()) and bool(g.any())


def test_weight_image_reads_back_through_the_swizzle():
    """Slab g = 4 m + s holds K rows s*64.. of matrix m; element (n, k) at
    bf16 offset n*64 + ((k%64 // 8) ^ (n % 8)) * 8 + k % 8 of the slab."""
    g = torch.Generator().manual_seed(0)
    w0s = torch.randn(5, 256, 256, generator=g)
    w1s = torch.randn(5, 256, 256, generator=g)
    img = tcbn.bf16_weight_image(w0s, w1s)
    assert img.shape == (40, 256, 64) and img.dtype == torch.bfloat16
    flat = img.reshape(40, -1)
    mats = torch.stack([w0s, w1s], 1).reshape(10, 256, 256).to(torch.bfloat16)
    n = torch.arange(256)[:, None]
    k = torch.arange(256)[None, :]
    off = n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
    for m in range(10):
        assert torch.equal(flat[4 * m + k // 64, off], mats[m].T), m


# ------------------------------------------------ the model and the Tester
def _model(decoder_bf16: bool, seed: int = 3):
    cfg = tconfig.load_config(TEST_YAML, mode="test")
    cfg["data"]["decoder_bf16"] = decoder_bf16
    return weights.init_seeded(
        tconfig.build_model(cfg, generate_limit=2, device="cpu"), seed)


@pytest.fixture(scope="module")
def models():
    return {False: _model(False), True: _model(True)}


def test_gradient_decoder_runs_the_bf16_chain(models):
    model = models[True]
    assert model.completion.mxu_dtype == torch.bfloat16
    rng = np.random.RandomState(4)
    feats = t((rng.randn(2, 512) * 0.5).astype(np.float32))
    codes = torch.nn.functional.one_hot(torch.tensor([1, 5]), 8).float()
    pts = t(rng.uniform(-0.55, 0.55, (2, 300, 3)).astype(np.float32))
    pts.requires_grad_(True)
    seen = []
    hook = model.completion.decoder.block0.register_forward_hook(
        lambda m, inp, out: seen.append(out.dtype))
    with torch.enable_grad():
        logits = model.gradient_decoder(feats, codes)(pts)
        grad, = torch.autograd.grad(logits.sum(), pts)
    hook.remove()
    assert seen == [torch.bfloat16] and logits.dtype == torch.float32
    assert bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)


def _batch():
    b = synthetic_scene_batch(np.random.RandomState(2), batch_size=1,
                              num_points=2048,
                              mean_size_arr=tconfig.MEAN_SIZE_ARR)
    return {k: np.asarray(v) for k, v in b.items()}


# (decoder_impl, upsampling_steps, decoder_bf16) -> the dtype of the grid
# or level decodes, and of the loss and voxel decodes
TESTER_CASES = {
    "pallas_dense": ("pallas", 0, False, torch.bfloat16, torch.float32),
    "pallas_mise": ("pallas", 1, False, torch.bfloat16, torch.float32),
    "none_dense": (None, 0, False, torch.float32, torch.float32),
    "flax_mise": ("flax", 1, False, torch.float32, torch.float32),
    "flax_dense_decoder_bf16": ("flax", 0, True, torch.bfloat16,
                                torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(TESTER_CASES))
def test_tester_decode_choice(case, models, monkeypatch):
    impl, steps, bf16, grid_dtype, other_dtype = TESTER_CASES[case]
    cfg = tconfig.load_config(TEST_YAML, mode="test")
    tconfig.update_recursive(cfg, {
        "seed": 0, "data": {"num_point": 2048, "decoder_bf16": bf16},
        "generation": {"decoder_impl": impl, "resolution_0": 6,
                       "upsampling_steps": steps, "dump_threshold": 0.0}})
    calls = []
    real = occnet.fused_cbn_decode

    def record(h0, *args, mxu_dtype=torch.float32, **kw):
        calls.append((h0.shape[1], mxu_dtype))
        return real(h0, *args, mxu_dtype=mxu_dtype, **kw)

    monkeypatch.setattr(occnet, "fused_cbn_decode", record)
    run = tester.Tester(cfg, models[bf16], log=lambda m: None)
    pending = run.dispatch_step(_batch())
    if pending["octree"] is not None:
        pending["octree"].wait()
    obj_points = _batch()["object_points"].shape[2]
    other = [d for n, d in calls if n in (obj_points, 16 ** 3)]
    grid = [d for n, d in calls if n not in (obj_points, 16 ** 3)]
    assert len(other) == 2 and set(other) == {other_dtype}
    # a dense grid is one decode of 6^3 points; MISE decodes a level a call
    assert len(grid) == (1 if steps == 0 else 2), calls
    assert set(grid) == {grid_dtype}


def test_decoder_impl_values():
    assert tester.decoder_impl_dtype({"decoder_impl": "pallas"}) is torch.bfloat16
    assert tester.decoder_impl_dtype({"decoder_impl": "flax"}) is None
    assert tester.decoder_impl_dtype({}) is None
    with pytest.raises(ValueError):
        tester.decoder_impl_dtype({"decoder_impl": "xla"})
