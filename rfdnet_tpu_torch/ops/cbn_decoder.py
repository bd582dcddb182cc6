"""Fused conditional-batch-norm occupancy decoder.

Counterpart of `rfdnet_tpu/ops/cbn_decoder.py`. Eval-mode
`DecoderCBatchNorm` after `fc_p`/`fc_z`: the 11 CBNs fold into
per-proposal scale/shift tables (`fold_cbn_constants`, plain torch), then
five blocks of [affine+ReLU -> @W0+b0 -> affine+ReLU -> @W1+b1 -> residual
add], a last affine+ReLU and a 256 -> 1 dot plus `b_out`.

`fused_cbn_decode` launches a hand-written kernel (the port of the Pallas
kernel `_make_kernel`/`fused_cbn_decode`) on a CUDA tensor and runs
`cbn_decode_plain` on a CPU tensor: `csrc/cbn_decoder.cu` in f32 (SIMT
FMAs), `csrc/cbn_decoder_bf16.cu` in bf16 (`wgmma` on the tensor cores,
its weights in the slab layout of `bf16_weight_image`).

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

from ..utils.profiling import count
from . import _native

H = 256
N_BLOCKS = 5
N_CBN = 2 * N_BLOCKS + 1
CBN_PAD = 16   # rows of the scale/shift tables (rows 0-10 used)
TILE_T = 64    # grid points per CTA of the f32 kernel; T pads to it
SLAB_K = 64    # K rows of a bf16-kernel weight slab (one 128-byte swizzle row)
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


def bf16_weight_image(w0s, w1s) -> torch.Tensor:
    """The ten block matrices as the bf16 kernel reads them: w0s/w1s (5, H, H)
    in (in, out) layout -> (40, H, SLAB_K) bf16, slab g = 4 m + s holding
    rows s*64 .. s*64+63 (K) of matrix m (in the order W0[0], W1[0],
    W0[1], ...). A slab is the exact shared-memory image that `wgmma`
    reads its B operand from: K-major (row n of the slab is output column
    n, its 64 K values 128 bytes), with the 128-byte swizzle: the 16-byte
    chunk c of row n sits at chunk c ^ (n % 8). One bulk copy moves it."""
    w = torch.stack([w0s, w1s], dim=1).reshape(2 * N_BLOCKS, H, H)
    nk = w.transpose(1, 2).to(torch.bfloat16)  # (m, n, k): K-major
    nk = nk.reshape(2 * N_BLOCKS, H, H // SLAB_K, SLAB_K // 8, 8)
    chunks = torch.arange(SLAB_K // 8, device=w.device)
    rows = torch.arange(H, device=w.device)
    src = chunks[None, :] ^ (rows[:, None] % 8)  # (n, stored chunk) -> chunk
    img = torch.gather(nk, 3, src[None, :, None, :, None].expand(nk.shape))
    return img.permute(0, 2, 1, 3, 4).reshape(
        2 * N_BLOCKS * (H // SLAB_K), H, SLAB_K).contiguous()


def _check_operands(h0, scales, shifts, b0s, b1s, w_out, b_out, h0_dtype):
    dev = h0.device
    Nb, T = h0.shape[0], h0.shape[1]
    f32 = torch.float32
    _native.check_tensor(h0, "h0", h0_dtype, (Nb, T, H), dev)
    for name, t in (("scales", scales), ("shifts", shifts)):
        _native.check_tensor(t, name, f32, (Nb, CBN_PAD, H), dev)
    for name, t in (("b0s", b0s), ("b1s", b1s)):
        _native.check_tensor(t, name, f32, (N_BLOCKS, H), dev)
    _native.check_tensor(w_out, "w_out", f32, (H,), dev)
    _native.check_tensor(b_out.reshape(1), "b_out", f32, (1,), dev)
    if Nb < 1 or T < 1:
        raise ValueError(f"cbn_decode: Nb={Nb}, T={T}")


def _decode_cuda(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out):
    """The f32 mode: csrc/cbn_decoder.cu."""
    dev = h0.device
    _check_operands(h0, scales, shifts, b0s, b1s, w_out, b_out, torch.float32)
    for name, t in (("w0s", w0s), ("w1s", w1s)):
        _native.check_tensor(t, name, torch.float32, (N_BLOCKS, H, H), dev)
    Nb, T = h0.shape[0], h0.shape[1]
    Tp = -(-T // TILE_T) * TILE_T
    if Tp != T:
        h0 = torch.nn.functional.pad(h0, (0, 0, 0, Tp - T))
    b_out = b_out.reshape(1).contiguous()
    out = torch.empty((Nb, Tp), dtype=torch.float32, device=dev)
    fn = _native.load("cbn_decoder").rfd_cbn_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*(_native.ptr(t) for t in (
                     h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out, out)),
                 Nb, Tp, 0, _native.stream(dev))
    _native.check_launch(err, "cbn_decode")
    count("ops.cbn_decode.launches")
    return out[:, :T]


def _decode_cuda_bf16(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                      w_image):
    """The bf16 mode: csrc/cbn_decoder_bf16.cu. h0 is rounded to bf16 here
    (as the TPU kernel casts it) unless it is bf16 already."""
    dev = h0.device
    h0 = h0.to(torch.bfloat16)
    _check_operands(h0, scales, shifts, b0s, b1s, w_out, b_out, torch.bfloat16)
    if w_image is None:
        w_image = bf16_weight_image(w0s, w1s)
    _native.check_tensor(w_image, "w_image", torch.bfloat16,
                         (2 * N_BLOCKS * (H // SLAB_K), H, SLAB_K), dev)
    Nb, T = h0.shape[0], h0.shape[1]
    b_out = b_out.reshape(1).contiguous()
    out = torch.empty((Nb, T), dtype=torch.float32, device=dev)
    fn = _native.load("cbn_decoder_bf16").rfd_cbn_decode_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*(_native.ptr(t) for t in (
                     h0, scales, shifts, w_image, b0s, b1s, w_out, b_out, out)),
                 Nb, T, _native.stream(dev))
    _native.check_launch(err, "cbn_decode bf16")
    count("ops.cbn_decode.launches")
    count("ops.cbn_decode.launches_bf16")
    return out


def fused_cbn_decode(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out,
                     mxu_dtype: torch.dtype = torch.float32,
                     w_image=None) -> torch.Tensor:
    """h0 (Nb, T, H) fc_p(+fc_z) output; scales/shifts (Nb, CBN_PAD, H);
    w0s/w1s (5, H, H) in (in, out) layout; b0s/b1s (5, H); w_out (H,);
    b_out a one-element tensor -> logits (Nb, T) f32.

    A CUDA `h0` goes to the kernel of `mxu_dtype`, a CPU `h0` to the plain
    version. The f32 kernel takes a float32 h0 and float32 weights; the
    bf16 kernel an h0 of float32 or bfloat16 and the weights as
    `w_image` (`bf16_weight_image(w0s, w1s)`, made here when None). Both
    take contiguous float32 tables and biases. The counter
    `ops.cbn_decode.launches` counts the launches of both kernels,
    `ops.cbn_decode.launches_bf16` those of the bf16 one."""
    _rounder(mxu_dtype)  # validates mxu_dtype
    if h0.device.type == "cpu":
        return cbn_decode_plain(h0, scales, shifts, w0s, b0s, w1s, b1s,
                                w_out, b_out, mxu_dtype)
    if mxu_dtype == torch.bfloat16:
        return _decode_cuda_bf16(h0, scales, shifts, w0s, b0s, w1s, b1s,
                                 w_out, b_out, w_image)
    return _decode_cuda(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out)

