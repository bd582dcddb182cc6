"""The eval-mode conditional-batch-norm occupancy decoder after
`fc_p`/`fc_z`, plain torch: the 11 CBNs folded into per-proposal
scale/shift tables, five blocks of [affine+ReLU -> @W0+b0 -> affine+ReLU
-> @W1+b1 -> residual add], a last affine+ReLU and a 256 -> 1 dot plus
`b_out`. `fused_cbn_decode` runs the chain `CHUNK` proposals at a time, so
that a decode of hundreds of proposals at 32^3 points fits in memory."""

from __future__ import annotations

import torch

H = 256
N_BLOCKS = 5
N_CBN = 2 * N_BLOCKS + 1
CBN_PAD = 16   # rows of the scale/shift tables (rows 0-10 used)
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


def cbn_decode_plain(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out,
                     b_out) -> torch.Tensor:
    """The plain torch version of the kernel, on any device. Arguments as
    `fused_cbn_decode`."""
    h = h0.float()
    sc = scales.float()[:, :, None, :]  # (Nb, CBN_PAD, 1, H)
    sh = shifts.float()[:, :, None, :]
    w0, w1 = w0s.float(), w1s.float()

    def affine_relu(x, row):
        return torch.relu(x * sc[:, row] + sh[:, row])

    for i in range(N_BLOCKS):
        t = affine_relu(h, 2 * i)
        t = t @ w0[i] + b0s[i]
        t = affine_relu(t, 2 * i + 1)
        t = t @ w1[i] + b1s[i]
        h = h + t
    hf = affine_relu(h, 2 * N_BLOCKS)
    return (hf * w_out).sum(-1) + b_out.reshape(())


CHUNK = 32  # proposals a plain chain holds at once


def fused_cbn_decode(h0, scales, shifts, w0s, b0s, w1s, b1s, w_out,
                     b_out) -> torch.Tensor:
    """h0 (Nb, T, H); scales/shifts (Nb, CBN_PAD, H); w0s/w1s (5, H, H) in
    (in, out) layout; b0s/b1s (5, H); w_out (H,); b_out one element ->
    logits (Nb, T) f32, `CHUNK` proposals at a time."""
    return torch.cat([
        cbn_decode_plain(h0[i:i + CHUNK], scales[i:i + CHUNK],
                         shifts[i:i + CHUNK], w0s, b0s, w1s, b1s, w_out,
                         b_out)
        for i in range(0, h0.shape[0], CHUNK)])
