"""Occupancy network (ONet): conditional implicit decoder + VAE latent.

Counterpart of `rfdnet_tpu/models/occnet.py`: `make_3d_grid`,
`ONet._cond`, `decode` (the layer-by-layer chain), `bind_fused` (fc_p/fc_z
and the CBN fold in torch, the block chain through
`ops.fused_cbn_decode`), `infer_z` (the VAE posterior encoder) and the
training loss `compute_loss`, which decodes a sampled z layer by layer,
with batch statistics and autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import fold_cbn_constants, fused_cbn_decode
from ..ops.cbn_decoder import CHUNK
from .layers import DecoderCBatchNorm, EncoderLatent


def make_3d_grid(bb_min, bb_max, shape, device=None) -> torch.Tensor:
    """Dense grid of prod(shape) points, x slowest, z fastest -> (P, 3)."""
    axes = [torch.linspace(bb_min[i], bb_max[i], shape[i], device=device)
            for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       dim=-1)


class ONet(nn.Module):
    def __init__(self, z_dim: int = 32, c_dim: int = 512,
                 use_cls_for_completion: bool = False, num_class: int = 8):
        super().__init__()
        self.z_dim = z_dim
        self.use_cls_for_completion = use_cls_for_completion
        cond_dim = c_dim + num_class * use_cls_for_completion
        self.decoder = DecoderCBatchNorm(c_dim=cond_dim, z_dim=z_dim)
        # registered after the decoder, as in the port, so that the state
        # keys come in the same order
        if z_dim != 0:
            self.encoder_latent = EncoderLatent(c_dim=cond_dim, z_dim=z_dim)

    def _cond(self, features, cls_codes):
        if self.use_cls_for_completion:
            features = torch.cat([features, cls_codes.float()], dim=-1)
        return features

    def decode(self, p, z, c):
        """p (Nb, T, 3), z (Nb, z_dim) | None, c (Nb, c_dim) -> logits."""
        return self.decoder(p, z, c)

    def bind_fused(self, z, c) -> "FusedDecoder":
        """The fused decode of z (Nb, z_dim) and codes c (Nb, c_dim) with
        its CBN tables and stacked weights folded once."""
        return FusedDecoder(self, z, c)

    def infer_z(self, p, occ, c):
        """Posterior (mean, logstd) of z, each (Nb, z_dim)."""
        if self.z_dim != 0:
            return self.encoder_latent(p, occ, c)
        zeros = torch.zeros((p.shape[0], 0), device=p.device)
        return zeros, zeros

    def compute_loss(self, input_features, input_points, input_points_occ,
                     cls_codes, eps):
        """The training loss: KL(q(z | points, occ, c) || N(0, I)) summed
        over z, plus the BCE of the decode at z = mean + std * eps summed
        over points, averaged over the objects.

        input_features (Nb, c_dim), input_points (Nb, T, 3),
        input_points_occ (Nb, T), cls_codes (Nb, num_class), eps (Nb,
        z_dim) -> loss scalar."""
        c = self._cond(input_features, cls_codes)
        mean_z, logstd_z = self.infer_z(input_points, input_points_occ, c)
        # clamped before exp: a drifting logstd would overflow to inf
        logstd_z = torch.clamp(logstd_z, -20.0, 20.0)
        std = torch.exp(logstd_z)
        kl = 0.5 * torch.sum(std ** 2 + mean_z ** 2 - 1.0 - 2.0 * logstd_z,
                             dim=-1)
        logits = self.decode(input_points, mean_z + std * eps, c)
        bce = _bce_with_logits(logits, input_points_occ)
        per_obj = kl + torch.sum(bce, dim=-1)
        return torch.sum(per_obj) / per_obj.numel()


def _bce_with_logits(logits, targets):
    """Binary cross entropy with logits, elementwise (no reduction)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


class FusedDecoder:
    """The fused decode bound to one z and one set of codes: the CBN
    tables and the stacked block weights are computed once, then each call
    decodes points p (Nb, T, 3) -> logits (Nb, T)."""

    def __init__(self, onet: ONet, z, c):
        dec = onet.decoder
        self.decoder = dec
        scales, shifts = fold_cbn_constants(dec, c)
        self.scales, self.shifts = scales.contiguous(), shifts.contiguous()
        self.z = z
        stack_w = lambda f: torch.stack(
            [getattr(b, f).weight.T for b in dec.blocks]).contiguous()
        stack_b = lambda f: torch.stack([getattr(b, f).bias for b in dec.blocks])
        self.blocks = (stack_w("fc_0"), stack_b("fc_0"), stack_w("fc_1"),
                       stack_b("fc_1"), dec.fc_out.weight[0].contiguous(),
                       dec.fc_out.bias)

    def __call__(self, p):
        """`CHUNK` proposals at a time, h0 included, so that hundreds of
        proposals at 32^3 points fit in memory."""
        return torch.cat([
            fused_cbn_decode(
                self.decoder.first_layer(p[i:i + CHUNK],
                                         self.z[i:i + CHUNK]).contiguous(),
                self.scales[i:i + CHUNK], self.shifts[i:i + CHUNK],
                *self.blocks)
            for i in range(0, p.shape[0], CHUNK)])
