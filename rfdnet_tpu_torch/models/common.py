"""Common building blocks, channels-last, eval mode.

Counterpart of `rfdnet_tpu/models/common.py`. Module and parameter names
follow the flax tree (`dense0`, `bn0`, ...) so that `weights.from_flax`
is a mechanical rename. BatchNorm uses its running statistics only: the
port has no training path yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Dense(nn.Linear):
    """Linear layer; `zero_init` marks the layers the JAX package
    initialises with a zero kernel (read by `weights.init_seeded`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis, torch semantics (eps 1e-5),
    in the JAX package's operation order:
    (x - mean) * rsqrt(var + eps) * scale + bias."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


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
    """Max over the points axis."""
    return x.amax(dim=dim, keepdim=keepdim)
