"""The port's fused CBN decoder (`rfdnet_tpu_torch/ops/cbn_decoder.py`)
against the JAX package's Pallas kernel, run as its own tests run it on
the CPU (`fused_cbn_decode(..., interpret=True)`), and against the flax
`DecoderCBatchNorm` chain.

Tolerances (as `tests/test_cbn_decoder.py`): the f32 chain atol 2e-5,
rtol 1e-5 (same math up to reduction order); the bf16-operand chain
within 2e-2 * max(scale, 1) of the f32 reference, with occupancy signs
that agree except on near-zero logits (bf16 rounding of the carry and
of each matmul result moves logits by ~1e-3 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.models.layers import DecoderCBatchNorm as JaxDecoder
from rfdnet_tpu.ops import cbn_decoder as jcbn
from rfdnet_tpu_torch.models.layers import DecoderCBatchNorm
from rfdnet_tpu_torch.models.occnet import ONet
from rfdnet_tpu_torch.ops import cbn_decoder as tcbn
from torch_parity import apply_flax, assert_close, init_flax, load_port, t

NB, T, CD = 3, 700, 512


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    p = rng.randn(NB, T, 3).astype(np.float32) * 0.3
    z = np.zeros((NB, 32), np.float32)
    c = rng.randn(NB, CD).astype(np.float32) * 0.5
    dec = JaxDecoder()
    vs = init_flax(dec, 0, jnp.asarray(p), jnp.asarray(z), jnp.asarray(c),
                   False)
    port = load_port(DecoderCBatchNorm(), vs)
    return dec, vs, port, p, z, c


def _jax_operands(vs, p, z, c):
    dp, st = vs["params"], vs["batch_stats"]
    h0 = p @ dp["fc_p"]["kernel"] + dp["fc_p"]["bias"]
    h0 = h0 + (z @ dp["fc_z"]["kernel"] + dp["fc_z"]["bias"])[:, None, :]
    sc, sh = jcbn.fold_cbn_constants(dp, st, jnp.asarray(c))
    stack = lambda f, leaf: np.stack(
        [dp[f"block{i}"][f][leaf] for i in range(5)])
    return (h0, np.asarray(sc), np.asarray(sh), stack("fc_0", "kernel"),
            stack("fc_0", "bias"), stack("fc_1", "kernel"),
            stack("fc_1", "bias"), dp["fc_out"]["kernel"][:, 0],
            dp["fc_out"]["bias"])


def test_fold_matches_jax(setup):
    _, vs, port, p, z, c = setup
    ops = _jax_operands(vs, p, z, c)
    sc, sh = tcbn.fold_cbn_constants(port, t(c))
    assert sc.shape == (NB, tcbn.CBN_PAD, tcbn.H)
    assert_close(sc, ops[1], atol=2e-5, rtol=1e-5)
    assert_close(sh, ops[2], atol=2e-5, rtol=1e-5)
    assert (sc[:, tcbn.N_CBN:] == 0).all() and (sh[:, tcbn.N_CBN:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(setup, dtype):
    """The same operands through the Pallas kernel (interpret mode) and
    the port's CPU path of `fused_cbn_decode`."""
    _, vs, _, p, z, c = setup
    ops = _jax_operands(vs, p, z, c)
    want = np.asarray(jcbn.fused_cbn_decode(
        *(jnp.asarray(o) for o in ops[:-1]), jnp.asarray(ops[-1][0]),
        interpret=True, mxu_dtype=getattr(jnp, dtype)))
    got = tcbn.fused_cbn_decode(*(t(o) for o in ops),
                                mxu_dtype=getattr(torch, dtype)).numpy()
    if dtype == "float32":
        assert_close(got, want, atol=2e-5, rtol=1e-5)
    else:
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() < 2e-2 * scale
        near = np.abs(want) < 1e-2 * scale
        assert (((got >= 0) == (want >= 0)) | near).all()
        # the bf16 roundings were made: nearer the Pallas bf16 chain than
        # the f32 one
        f32 = tcbn.cbn_decode_plain(*(t(o) for o in ops)).numpy()
        assert np.abs(got - want).max() < np.abs(got - f32).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_fused_matches_flax_chain(setup, dtype):
    """ONet.decode_fused (fc_p/fc_z, fold, fused chain) against the flax
    decoder's layer-by-layer f32 chain, and the port's own chain."""
    dec, vs, port, p, z, c = setup
    ref = np.asarray(apply_flax(dec, vs, jnp.asarray(p), jnp.asarray(z),
                                jnp.asarray(c), False))
    onet = ONet(decoder_bf16=dtype == "bfloat16")
    onet.decoder = port
    out = onet.decode_fused(t(p), t(z), t(c)).numpy()
    assert_close(port(t(p), t(z), t(c)), ref, atol=2e-5, rtol=1e-5)
    if dtype == "float32":
        assert_close(out, ref, atol=2e-5, rtol=1e-5)
    else:
        scale = max(np.abs(ref).max(), 1.0)
        assert np.abs(out - ref).max() < 2e-2 * scale
        agree = (out >= 0) == (ref >= 0)
        near = np.abs(ref) < 1e-2 * scale
        assert (agree | near).all()


def test_decode_ragged_t_and_bad_dtype(setup):
    _, vs, port, p, z, c = setup
    ops = [t(o) for o in _jax_operands(vs, p[:, :37], z, c)]
    out = tcbn.fused_cbn_decode(*ops)
    assert out.shape == (NB, 37)
    with pytest.raises(ValueError):
        tcbn.fused_cbn_decode(*ops, mxu_dtype=torch.float16)
