"""Occupancy network (ONet), eval decode.

Counterpart of `rfdnet_tpu/models/occnet.py`: `make_3d_grid`,
`ONet._cond`, `decode` (the layer-by-layer chain) and `decode_fused`
(fc_p/fc_z and the CBN fold in torch, the block chain through
`ops.fused_cbn_decode`, i.e. the CUDA kernel on the card). The VAE
encoder and the training loss are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import fold_cbn_constants, fused_cbn_decode
from .layers import DecoderCBatchNorm


def make_3d_grid(bb_min, bb_max, shape, device=None) -> torch.Tensor:
    """Dense grid of prod(shape) points, x slowest, z fastest -> (P, 3)."""
    axes = [torch.linspace(bb_min[i], bb_max[i], shape[i], device=device)
            for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       dim=-1)


class ONet(nn.Module):
    def __init__(self, z_dim: int = 32, c_dim: int = 512,
                 use_cls_for_completion: bool = False, num_class: int = 8,
                 decoder_bf16: bool = False):
        super().__init__()
        self.z_dim = z_dim
        self.use_cls_for_completion = use_cls_for_completion
        self.mxu_dtype = torch.bfloat16 if decoder_bf16 else torch.float32
        cond_dim = c_dim + num_class * use_cls_for_completion
        self.decoder = DecoderCBatchNorm(c_dim=cond_dim, z_dim=z_dim)

    def _cond(self, features, cls_codes):
        if self.use_cls_for_completion:
            features = torch.cat([features, cls_codes.float()], dim=-1)
        return features

    def decode(self, p, z, c):
        """p (Nb, T, 3), z (Nb, z_dim) | None, c (Nb, c_dim) -> logits."""
        return self.decoder(p, z, c)

    def fused_operands(self, p, z, c):
        """The operands of `ops.fused_cbn_decode` for points p (Nb, T, 3),
        z (Nb, z_dim) and codes c: fc_p/fc_z output, folded CBN tables,
        stacked (in, out) block weights and biases, and the output layer."""
        dec = self.decoder
        scales, shifts = fold_cbn_constants(dec, c)
        stack_w = lambda f: torch.stack(
            [getattr(b, f).weight.T for b in dec.blocks]).contiguous()
        stack_b = lambda f: torch.stack([getattr(b, f).bias for b in dec.blocks])
        return (dec.first_layer(p, z).contiguous(), scales.contiguous(),
                shifts.contiguous(), stack_w("fc_0"), stack_b("fc_0"),
                stack_w("fc_1"), stack_b("fc_1"),
                dec.fc_out.weight[0].contiguous(), dec.fc_out.bias)

    def decode_fused(self, p, z, c):
        """`decode` through the fused kernel, in `mxu_dtype` operands."""
        return fused_cbn_decode(*self.fused_operands(p, z, c),
                                mxu_dtype=self.mxu_dtype)
