"""ONet-family building blocks, channels-last.

Counterpart of `rfdnet_tpu/models/layers.py`: `ResnetBlockFC`,
`CBatchNorm`, `_AffinelessBatchNorm`, `CResnetBlockConv1d`,
`ResnetPointnet`, `DecoderCBatchNorm`, `EncoderLatent`, in float32. A
CBatchNorm's conditional affine
is two `Dense` layers, `gamma` and `beta` (the flax `gamma_kernel/
gamma_bias` and `beta_kernel/beta_bias`).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Dense, batch_statistics, max_pool_points


class ResnetBlockFC(nn.Module):
    """Keeps the reference's in-place-ReLU quirk: the shortcut reads
    relu(x), so the block computes
    shortcut(relu(x)) + fc_1(relu(fc_0(relu(x))))."""

    def __init__(self, size_in: int, size_out: int | None = None,
                 size_h: int | None = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = Dense(size_in, size_h)
        self.fc_1 = Dense(size_h, size_out, zero_init=True)
        self.shortcut = (Dense(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x):
        xr = torch.relu(x)
        dx = self.fc_1(torch.relu(self.fc_0(xr)))
        x_s = self.shortcut(xr) if self.shortcut is not None else xr
        return x_s + dx


class _AffinelessBatchNorm(nn.Module):
    """Batch norm without affine, folded to x * scale + shift with
    scale = rsqrt(var + eps) and shift = -mean * scale: the batch's
    statistics in train mode (updating the running ones with `momentum`,
    see `common.batch_statistics`), the running ones in eval mode."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            mean, var = batch_statistics(x, self.running_mean,
                                         self.running_var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps)
        return x * scale + (-mean * scale)


class CBatchNorm(nn.Module):
    """Conditional batch norm: affine-free BN, then a per-channel affine
    (gamma, beta) predicted from the code c. x (B, T, f), c (B, c_dim)."""

    def __init__(self, c_dim: int, f_dim: int):
        super().__init__()
        self.gamma = Dense(c_dim, f_dim, zero_init=True)
        self.beta = Dense(c_dim, f_dim, zero_init=True)
        self.bn = _AffinelessBatchNorm(f_dim)

    def forward(self, x, c):
        net = self.bn(x)
        g, b = self.gamma(c), self.beta(c)
        return g[:, None, :] * net + b[:, None, :]


class CResnetBlockConv1d(nn.Module):
    """Conditional-BN resnet block (zero-init fc_1)."""

    def __init__(self, c_dim: int, size_in: int, size_h: int | None = None,
                 size_out: int | None = None):
        super().__init__()
        size_h = size_h or size_in
        size_out = size_out or size_in
        self.bn_0 = CBatchNorm(c_dim, size_in)
        self.fc_0 = Dense(size_in, size_h)
        self.bn_1 = CBatchNorm(c_dim, size_h)
        self.fc_1 = Dense(size_h, size_out, zero_init=True)
        self.shortcut = (Dense(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x, c):
        net = self.fc_0(torch.relu(self.bn_0(x, c)))
        dx = self.fc_1(torch.relu(self.bn_1(net, c)))
        x_s = self.shortcut(x) if self.shortcut is not None else x
        return x_s + dx


class ResnetPointnet(nn.Module):
    """PointNet encoder with 5 resnet blocks and max-pool-concat:
    p (B, T, dim) -> c (B, c_dim)."""

    def __init__(self, dim: int, c_dim: int = 512, hidden_dim: int = 512):
        super().__init__()
        self.fc_pos = Dense(dim, 2 * hidden_dim)
        for i in range(5):
            self.add_module(f"block_{i}",
                            ResnetBlockFC(2 * hidden_dim, hidden_dim))
        self.fc_c = Dense(hidden_dim, c_dim)

    def forward(self, p):
        net = self.fc_pos(p)
        for i in range(4):
            net = getattr(self, f"block_{i}")(net)
            pooled = max_pool_points(net, dim=1, keepdim=True)
            net = torch.cat([net, pooled.expand_as(net)], dim=-1)
        net = max_pool_points(self.block_4(net), dim=1)
        return self.fc_c(torch.relu(net))


class DecoderCBatchNorm(nn.Module):
    """Conditional-batch-norm implicit decoder: fc_p (3 -> hidden), fc_z,
    5 CResnet blocks conditioned on c, CBN -> ReLU -> fc_out logits.
    `forward` is the layer-by-layer chain; `ops.fused_cbn_decode` is the
    fused one."""

    def __init__(self, c_dim: int = 512, hidden_size: int = 256,
                 n_blocks: int = 5, z_dim: int = 32):
        super().__init__()
        self.z_dim = z_dim
        self.fc_p = Dense(3, hidden_size)
        if z_dim != 0:
            self.fc_z = Dense(z_dim, hidden_size)
        for i in range(n_blocks):
            self.add_module(f"block{i}", CResnetBlockConv1d(c_dim, hidden_size))
        self.n_blocks = n_blocks
        self.bn = CBatchNorm(c_dim, hidden_size)
        self.fc_out = Dense(hidden_size, 1)

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    def first_layer(self, p, z):
        """fc_p(p) (+ fc_z(z)): (Nb, T, 3), (Nb, z_dim) -> (Nb, T, hidden)."""
        net = self.fc_p(p)
        if self.z_dim != 0 and z is not None:
            net = net + self.fc_z(z)[:, None, :]
        return net

    def forward(self, p, z, c):
        """p (B, T, 3), z (B, z_dim) | None, c (B, c_dim) -> logits (B, T)."""
        net = self.first_layer(p, z)
        for blk in self.blocks:
            net = blk(net, c)
        return self.fc_out(torch.relu(self.bn(net, c)))[..., 0]


class EncoderLatent(nn.Module):
    """VAE posterior encoder q(z | points, occupancies, c): 128-wide MLPs
    with max-pool concatenation. p (B, T, 3), occ (B, T), c (B, c_dim) ->
    (mean (B, z_dim), logstd (B, z_dim))."""

    def __init__(self, c_dim: int = 512, z_dim: int = 32, hidden: int = 128):
        super().__init__()
        self.fc_0 = Dense(1, hidden)
        self.fc_pos = Dense(3, hidden)
        self.fc_c = Dense(c_dim, hidden) if c_dim else None
        self.fc_1 = Dense(hidden, hidden)
        self.fc_2 = Dense(2 * hidden, hidden)
        self.fc_3 = Dense(2 * hidden, hidden)
        self.fc_mean = Dense(hidden, z_dim)
        self.fc_logstd = Dense(hidden, z_dim)

    def forward(self, p, occ, c):
        net = self.fc_0(occ[..., None]) + self.fc_pos(p)
        if self.fc_c is not None:
            net = net + self.fc_c(c)[:, None, :]

        def pool_cat(net):
            pooled = max_pool_points(net, dim=1, keepdim=True)
            return torch.cat([net, pooled.expand_as(net)], dim=-1)

        net = pool_cat(self.fc_1(torch.relu(net)))
        net = pool_cat(self.fc_2(torch.relu(net)))
        net = max_pool_points(self.fc_3(torch.relu(net)), dim=1)
        return self.fc_mean(net), self.fc_logstd(net)
