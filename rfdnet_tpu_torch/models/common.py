"""Common building blocks, channels-last.

Counterpart of `rfdnet_tpu/models/common.py`. Module and parameter names
follow the flax tree (`dense0`, `bn0`, ...) so that `weights.from_flax`
is a mechanical rename. A module's train mode is torch's (`model.train()`
/ `model.eval()`); the batch norms' momentum is an attribute that
`set_bn_momentum` sets (the JAX package passes it to every call).

The bf16 chains (`data.mlp_bf16`, `set_compute_dtype`; the decoder's
blocks under `data.decoder_bf16`): a `Dense` with a `compute_dtype`
multiplies in that type as the JAX package's `Dense` does (operands
rounded to it, the products summed in f32, the f32 bias added in f32, and
that sum rounded once to the type it returns; `low_precision_product`);
a batch norm normalises in f32 and returns its input's type. Parameters stay f32. A `Dense` without one
takes its input in f32 (the f32 heads of a bf16 chain).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..collectives import all_sum


class Dense(nn.Linear):
    """Linear layer; `zero_init` marks the layers the JAX package
    initialises with a zero kernel (read by `weights.init_seeded`);
    `compute_dtype`: see the module docstring."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init
        self.compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x.to(self.weight.dtype))
        y = low_precision_product(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias
        return y.to(dt)


class _LowPrecisionProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return x.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (g @ w.float()).to(x.dtype), (g.t() @ x.float()).to(w.dtype)


def low_precision_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T for x (..., in) and w (out, in) in one low-precision type,
    the exact products summed in f32 and returned in f32: on the card one
    tensor-core GEMM with an f32 output (`torch.mm(out_dtype=)`), on the
    CPU the f32 product of the widened operands. The gradients are f32
    products of the widened operands rounded to the operands' type, as
    JAX's transposed dot gives them; they are differentiable again (the
    refinement's second derivatives)."""
    y = _LowPrecisionProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[0])


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Give every `Dense` of `module`'s tree the `compute_dtype` `dtype`
    (None: f32), except the f32 heads that their owners list in
    `F32_HEADS`."""
    for owner in module.modules():
        heads = getattr(owner, "F32_HEADS", ())
        for name, child in owner.named_children():
            if isinstance(child, Dense) and name not in heads:
                child.compute_dtype = dtype


def batch_statistics(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float,
                     group=None):
    """Train-mode statistics of x (..., C) over every leading axis, in f32
    (f64 for f64 input), as the JAX package computes them: the mean and the
    mean of squares, var = max(mean_sq - mean^2, 0) (biased, for
    normalising). The running buffers are updated in place with the
    unbiased var * n / (n - 1), as new = (1 - m) * old + m * batch.
    Returns (mean, var).

    `group` (a `collectives.DataGroup`, or None): the statistics of the
    global batch (sync-BN, the JAX package's batch norm under its data
    mesh). The sum, the sum of squares and the count go through one
    vector (f32, f64 for f64 input) summed over the ranks inside autograd (`collectives.all_sum`,
    the vector itself without a group; counts exact below 2^24), then
    mean = sum / n and mean_sq = sumsq / n, n the global count."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.dim() - 1))
    C = x.shape[-1]
    sums = all_sum(torch.cat([
        xf.sum(dim=dims), torch.square(xf).sum(dim=dims),
        xf.new_full((1,), float(x.numel() // C))]), group)
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
    (`batch_statistics`, over `data_group`'s global batch when set, see
    `set_data_group`) and updates the running ones with `momentum`; eval
    mode uses the running ones."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            mean, var = batch_statistics(x, self.running_mean,
                                         self.running_var, self.momentum,
                                         self.data_group)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def set_data_group(model: nn.Module, group) -> None:
    """Give every module of `model` that reduces over the batch (its
    batch norms, and the modules whose losses take batch means) the data
    group `group` (`collectives.DataGroup`; None: this process's batch
    alone). Each reads its own `data_group`; the loss functions it calls
    take it as their `group` argument."""
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = group


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
