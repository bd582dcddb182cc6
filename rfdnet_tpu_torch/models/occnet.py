"""Occupancy network (ONet): conditional implicit decoder + VAE latent.

Counterpart of `rfdnet_tpu/models/occnet.py`: `make_3d_grid`,
`ONet._cond`, `decode` (the layer-by-layer chain), `decode_fused`
(fc_p/fc_z and the CBN fold in torch, the block chain through
`ops.fused_cbn_decode`, i.e. the CUDA kernel on the card), `infer_z` (the
VAE posterior encoder) and `compute_loss`. In train mode the loss decodes
a sampled z layer by layer, with batch statistics and autograd; in eval
mode both of its decodes go through `decode_fused`, which folds the
running statistics and has no gradient. `decoder_bf16` (the config's
`data.decoder_bf16`) makes both bf16: the layer chain
(`DecoderCBatchNorm.compute_dtype`) and the fused decode's operands
(`mxu_dtype`, the tensor-core kernel on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import fold_cbn_constants, fused_cbn_decode
from ..ops.cbn_decoder import bf16_weight_image
from .layers import DecoderCBatchNorm, EncoderLatent
from ..collectives import global_sum


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
                 decoder_bf16: bool = False, threshold: float = 0.5):
        super().__init__()
        self.z_dim = z_dim
        self.threshold = threshold
        self.use_cls_for_completion = use_cls_for_completion
        self.mxu_dtype = torch.bfloat16 if decoder_bf16 else torch.float32
        self.data_group = None  # see `common.set_data_group`
        cond_dim = c_dim + num_class * use_cls_for_completion
        self.decoder = DecoderCBatchNorm(
            c_dim=cond_dim, z_dim=z_dim,
            compute_dtype=torch.bfloat16 if decoder_bf16 else None)
        # registered after the decoder, so that `weights.init_seeded` draws
        # the decoder's values before the encoder's
        if z_dim != 0:
            self.encoder_latent = EncoderLatent(c_dim=cond_dim, z_dim=z_dim)

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
        return self.bind_fused(z, c).operands(p)

    def bind_fused(self, z, c, mxu_dtype=None) -> "FusedDecoder":
        """The fused decode of z (Nb, z_dim) and codes c (Nb, c_dim) with
        its CBN tables and stacked weights folded once, for any number of
        point sets, in `mxu_dtype` operands (the decoder's own,
        `self.mxu_dtype`, when None)."""
        return FusedDecoder(self, z, c, mxu_dtype)

    def decode_fused(self, p, z, c):
        """`decode` through the fused kernel, in `mxu_dtype` operands."""
        return self.bind_fused(z, c)(p)

    def infer_z(self, p, occ, c):
        """Posterior (mean, logstd) of z, each (Nb, z_dim)."""
        if self.z_dim != 0:
            return self.encoder_latent(p, occ, c)
        zeros = torch.zeros((p.shape[0], 0), device=p.device)
        return zeros, zeros

    def compute_loss(self, input_features, input_points, input_points_occ,
                     cls_codes, export_shape: bool = False, valid_mask=None,
                     eps=None, generator=None):
        """KL(q(z | points, occ, c) || N(0, I)) summed over z, plus the BCE
        of the decode summed over points, averaged over the objects
        (weighted by `valid_mask` (Nb,) when given). With `export_shape`,
        also the (Nb, 16, 16, 16) occupancy voxels at the prior mean z.

        Train mode (`self.training`): z = mean + std * eps, eps (Nb, z_dim)
        given or drawn from `generator`, decoded by `decode`. Eval mode: z
        is the posterior mean, decoded by `decode_fused`. With a `data_group`, the
        mean over the global batch's objects (`collectives.global_sum`).

        input_features (Nb, c_dim), input_points (Nb, T, 3),
        input_points_occ (Nb, T), cls_codes (Nb, num_class) ->
        (loss scalar, voxels bool or None)."""
        c = self._cond(input_features, cls_codes)
        Nb = c.shape[0]
        mean_z, logstd_z = self.infer_z(input_points, input_points_occ, c)
        # clamped before exp: a drifting logstd would overflow to inf
        logstd_z = torch.clamp(logstd_z, -20.0, 20.0)
        std = torch.exp(logstd_z)
        kl = 0.5 * torch.sum(std ** 2 + mean_z ** 2 - 1.0 - 2.0 * logstd_z,
                             dim=-1)
        if self.training:
            if eps is None:
                eps = torch.randn(mean_z.shape, generator=generator,
                                  device=mean_z.device if generator is None
                                  else generator.device).to(mean_z.device)
            logits = self.decode(input_points, mean_z + std * eps, c)
        else:
            logits = self.decode_fused(input_points, mean_z, c)
        bce = _bce_with_logits(logits, input_points_occ)
        per_obj = kl + torch.sum(bce, dim=-1)
        if valid_mask is not None:
            w = valid_mask.float()
            loss = torch.sum(per_obj * w) / torch.clamp(
                global_sum(torch.sum(w), self.data_group), min=1e-6)
        else:
            loss = torch.sum(per_obj) / global_sum(per_obj.numel(),
                                                   self.data_group)

        voxels = None
        if export_shape:
            shape = (16, 16, 16)
            p = make_3d_grid([-0.5 + 1 / 32] * 3, [0.5 - 1 / 32] * 3, shape,
                             device=c.device)
            z0 = torch.zeros((Nb, self.z_dim), device=c.device)
            with torch.no_grad():
                logits_v = self.decode_fused(p[None].expand(Nb, -1, -1), z0,
                                             c)
            voxels = (torch.sigmoid(logits_v) >= self.threshold).reshape(
                Nb, *shape)
        return loss, voxels


def _bce_with_logits(logits, targets):
    """Binary cross entropy with logits, elementwise (no reduction)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


class FusedDecoder:
    """`ONet.decode_fused` bound to one z and one set of codes: the CBN
    tables and the stacked block weights (for the bf16 kernel on the card,
    also their slab image, `ops.cbn_decoder.bf16_weight_image`) are
    computed once, then each call decodes points p (k, T, 3) of the
    proposals `rows` ((k,) int64, all Nb when None) -> logits (k, T)."""

    def __init__(self, onet: ONet, z, c, mxu_dtype=None):
        dec = onet.decoder
        self.decoder = dec
        self.mxu_dtype = onet.mxu_dtype if mxu_dtype is None else mxu_dtype
        scales, shifts = fold_cbn_constants(dec, c)
        self.scales, self.shifts = scales.contiguous(), shifts.contiguous()
        self.z = z
        stack_w = lambda f: torch.stack(
            [getattr(b, f).weight.T for b in dec.blocks]).contiguous()
        stack_b = lambda f: torch.stack([getattr(b, f).bias for b in dec.blocks])
        self.blocks = (stack_w("fc_0"), stack_b("fc_0"), stack_w("fc_1"),
                       stack_b("fc_1"), dec.fc_out.weight[0].contiguous(),
                       dec.fc_out.bias)
        self.bf16 = self.mxu_dtype == torch.bfloat16
        self.w_image = (bf16_weight_image(self.blocks[0], self.blocks[2])
                        if self.bf16 and c.device.type == "cuda" else None)

    def operands(self, p, rows=None):
        """The operands of `ops.fused_cbn_decode` for points p: h0 is f32,
        or bf16 in the bf16 mode (rounded as the kernel would)."""
        pick = (lambda t: t) if rows is None else (lambda t: t[rows])
        z = None if self.z is None else pick(self.z)
        h0 = self.decoder.first_layer(
            p, z, dtype=torch.bfloat16 if self.bf16 else None)
        return (h0.contiguous(), pick(self.scales).contiguous(),
                pick(self.shifts).contiguous(), *self.blocks)

    def __call__(self, p, rows=None):
        return fused_cbn_decode(*self.operands(p, rows),
                                mxu_dtype=self.mxu_dtype,
                                w_image=self.w_image)
