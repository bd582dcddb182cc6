"""Common building blocks, channels-last.

Counterpart of `rfdnet_tpu/models/common.py`. Module and parameter names
follow the flax tree (`dense0`, `bn0`, ...), as the port's do, so that
one state dict loads into both. A module's train mode is torch's (`model.train()`
/ `model.eval()`); the batch norms' momentum is an attribute that
`set_bn_momentum` sets (the JAX package passes it to every call).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Dense(nn.Linear):
    """Linear layer; `zero_init` marks the layers the JAX package
    initialises with a zero kernel (read by `rfdbench.weights`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def batch_statistics(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float):
    """Train-mode statistics of x (..., C) over every leading axis, in f32
    (f64 for f64 input), as the JAX package computes them: the mean and the
    mean of squares from the sum, the sum of squares and the count, var =
    max(mean_sq - mean^2, 0) (biased, for normalising). The running
    buffers are updated in place with the unbiased var * n / (n - 1), as
    new = (1 - m) * old + m * batch. Returns (mean, var)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.dim() - 1))
    C = x.shape[-1]
    sums = torch.cat([
        xf.sum(dim=dims), torch.square(xf).sum(dim=dims),
        xf.new_full((1,), float(x.numel() // C))])
    n = sums[-1]
    mean, mean_sq = sums[:C] / n, sums[C:2 * C] / n
    var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
    with torch.no_grad():
        unbiased = var * (n / torch.clamp(n - 1, min=1))
        running_mean.copy_((1.0 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1.0 - momentum) * running_var
                          + momentum * unbiased)
    return mean, var


class BatchNorm(nn.Module):
    """Batch norm over the last axis, torch semantics (eps 1e-5), in the
    JAX package's operation order: (x - mean) * rsqrt(var + eps) * scale +
    bias. Train mode normalises with the batch's statistics
    (`batch_statistics`) and updates the running ones with `momentum`; eval
    mode uses the running ones."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            mean, var = batch_statistics(x, self.running_mean,
                                         self.running_var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Set the momentum of every batch norm of `model` (the BN-momentum
    schedule's per-epoch value)."""
    for m in model.modules():
        if hasattr(m, "momentum") and hasattr(m, "running_mean"):
            m.momentum = float(momentum)


class SharedMLP(nn.Module):
    """[Dense -> BN -> ReLU] x len(features) over the channel axis (no
    Dense bias when followed by BN, as the reference's Conv2d)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense{i}", Dense(in_features, f, bias=False))
            self.add_module(f"bn{i}", BatchNorm(f))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x)))
        return x


class MLPHead(nn.Module):
    """[Dense -> BN -> ReLU] x len(hidden), then a linear output layer (the
    Dense layers keep their bias before BN, as the reference's Conv1d)."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 out_features: int):
        super().__init__()
        self.n = len(hidden)
        for i, f in enumerate(hidden):
            self.add_module(f"dense{i}", Dense(in_features, f))
            self.add_module(f"bn{i}", BatchNorm(f))
            in_features = f
        self.out = Dense(in_features, out_features)

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x)))
        return self.out(x)


def max_pool_points(x: torch.Tensor, dim: int = 1,
                    keepdim: bool = False) -> torch.Tensor:
    """Max over the points axis; its gradient splits evenly among tied
    maxima, as `jnp.max`'s does."""
    return x.amax(dim=dim, keepdim=keepdim)
