"""Fused conditional-batch-norm occupancy decoder.

Counterpart of `rfdnet_tpu/ops/cbn_decoder.py`. Eval-mode
`DecoderCBatchNorm` after `fc_p`/`fc_z`: the 11 CBNs fold into
per-proposal scale/shift tables (`fold_cbn_constants`, plain torch), then
five blocks of [affine+ReLU -> @W0+b0 -> affine+ReLU -> @W1+b1 -> residual
add], a last affine+ReLU and a 256 -> 1 dot plus `b_out`.

`fused_cbn_decode` launches the hand-written kernel `csrc/cbn_decoder.cu`
(the port of the Pallas kernel `_make_kernel`/`fused_cbn_decode`) on a
CUDA tensor and runs `cbn_decode_plain` on a CPU tensor.

Operand types, as the TPU kernel's `mxu_dtype`:
- float32: the whole chain in f32;
- bfloat16: the values the TPU kernel holds in bf16 are rounded to bf16
  (h0, the carry h, the scale/shift tables, the weights, each affine's
  product and its sum, each matmul+bias result); products accumulate in
  f32 and the output dot is f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

H = 256
N_BLOCKS = 5
N_CBN = 2 * N_BLOCKS + 1
CBN_PAD = 16   # rows of the scale/shift tables (rows 0-10 used)
TILE_T = 64    # grid points per CTA of the CUDA kernel; T pads to it
_EPS = 1e-5    # _AffinelessBatchNorm epsilon


def fold_cbn_constants(decoder, c: torch.Tensor):
    """Fold every CBN of `decoder` (a `models.layers.DecoderCBatchNorm`)
    into per-proposal tables. c (Nb, c_dim) -> (scales, shifts), each
    (Nb, CBN_PAD, H) f32, rows [block0.bn_0, block0.bn_1, ..., block4.bn_1,
    final bn, zero padding]."""
    def fold(cbn):
        g = torch.nn.functional.linear(c, cbn.gamma.weight, cbn.gamma.bias)
        b = torch.nn.functional.linear(c, cbn.beta.weight, cbn.beta.bias)
        inv = torch.rsqrt(cbn.bn.running_var + _EPS)
        return g * inv, b - g * cbn.bn.running_mean * inv

    cbns = [cbn for blk in decoder.blocks for cbn in (blk.bn_0, blk.bn_1)]
    rows = [fold(cbn) for cbn in cbns + [decoder.bn]]
    scales = torch.stack([a for a, _ in rows], dim=1)
    shifts = torch.stack([b for _, b in rows], dim=1)
    pad = (0, 0, 0, CBN_PAD - N_CBN)
    return (torch.nn.functional.pad(scales, pad),
            torch.nn.functional.pad(shifts, pad))


def _rounder(mxu_dtype: torch.dtype):
    if mxu_dtype == torch.float32:
        return lambda t: t
    if mxu_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    raise ValueError(f"mxu_dtype must be float32 or bfloat16, not {mxu_dtype}")


def cbn_decode_plain(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                     mxu_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain torch version of the kernel, on any device. Arguments as
    `fused_cbn_decode`."""
    q = _rounder(mxu_dtype)
    h = q(h0.float())
    sc = q(scales.float())[:, :, None, :]  # (Nb, CBN_PAD, 1, H)
    sh = q(shifts.float())[:, :, None, :]
    w0, w1 = q(w0s.float()), q(w1s.float())

    def affine_relu(x, row):  # a bf16 multiply, then a bf16 add
        return torch.relu(q(q(x * sc[:, row]) + sh[:, row]))

    for i in range(N_BLOCKS):
        t = affine_relu(h, 2 * i)
        t = q(t @ w0[i] + b0s[i])
        t = affine_relu(t, 2 * i + 1)
        t = q(t @ w1[i] + b1s[i])
        h = q(h + t)
    hf = affine_relu(h, 2 * N_BLOCKS)
    return (hf * w_out).sum(-1) + b_out.reshape(())


def _decode_cuda(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                 mxu_dtype):
    _rounder(mxu_dtype)  # validates mxu_dtype
    dev = h0.device
    Nb, T = h0.shape[0], h0.shape[1]
    f32 = torch.float32
    _native.check_tensor(h0, "h0", f32, (Nb, T, H), dev)
    for name, t in (("scales", scales), ("shifts", shifts)):
        _native.check_tensor(t, name, f32, (Nb, CBN_PAD, H), dev)
    for name, t in (("w0s", w0s), ("w1s", w1s)):
        if t.dtype not in (f32, torch.bfloat16):
            raise ValueError(f"{name}: dtype {t.dtype}")
        _native.check_tensor(t, name, t.dtype, (N_BLOCKS, H, H), dev)
    for name, t in (("b0s", b0s), ("b1s", b1s)):
        _native.check_tensor(t, name, f32, (N_BLOCKS, H), dev)
    _native.check_tensor(w_out, "w_out", f32, (H,), dev)
    _native.check_tensor(b_out.reshape(1), "b_out", f32, (1,), dev)
    if Nb < 1 or T < 1:
        raise ValueError(f"cbn_decode: Nb={Nb}, T={T}")
    Tp = -(-T // TILE_T) * TILE_T
    if Tp != T:
        h0 = torch.nn.functional.pad(h0, (0, 0, 0, Tp - T))
    # bf16 operands reach the kernel as their exact f32 widening: a
    # bf16 x bf16 product is exact in f32, so f32 FMAs on them are the
    # bf16-operand, f32-accumulate product
    w0 = w0s.to(mxu_dtype).float().contiguous()
    w1 = w1s.to(mxu_dtype).float().contiguous()
    b_out = b_out.reshape(1).contiguous()
    out = torch.empty((Nb, Tp), dtype=f32, device=dev)
    fn = _native.load("cbn_decoder").rfd_cbn_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*(_native.ptr(t) for t in (
                     h0, scales, shifts, w0, b0s, w1, b1s, w_out, b_out, out)),
                 Nb, Tp, int(mxu_dtype == torch.bfloat16),
                 _native.stream(dev))
    _native.check_launch(err, "cbn_decode")
    fused_cbn_decode.launches += 1
    return out[:, :T]


def fused_cbn_decode(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                     mxu_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """h0 (Nb, T, H) fc_p(+fc_z) output; scales/shifts (Nb, CBN_PAD, H);
    w0s/w1s (5, H, H) in (in, out) layout; b0s/b1s (5, H); w_out (H,);
    b_out a one-element tensor -> logits (Nb, T) f32.

    A CUDA `h0` goes to the kernel (contiguous float32 tables and biases
    required; the weights may be float32 or bfloat16), a CPU `h0` to the
    plain version."""
    if h0.device.type == "cpu":
        return cbn_decode_plain(h0, scales, shifts, w0s, b0s, w1s, b1s,
                                w_out, b_out, mxu_dtype)
    return _decode_cuda(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                        mxu_dtype)


fused_cbn_decode.launches = 0
