"""The data axis as the models and the data see it: a rank's view of the
group (`DataGroup`), its rows of a global batch (`shard_rows`), and the
two sums over the ranks that sync-BN and the global-batch loss take.

`parallel/mesh.py` starts the ranks and holds the other collectives of
the data-parallel paths; this module imports nothing of the port, so the
models (`models/common.py`, `models/losses.py`) and the loader
(`data/scannet.py`) depend on it and not on `parallel/`. Without a group
(None) every function here is the identity, so one formulation serves
one process and many.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """A rank's view of the data axis: the process group (None: the
    default one), this process's rank, the world size, the device its
    tensors live on."""

    group: object
    rank: int
    world: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rows [rank n / world, (rank + 1) n / world) of n."""
    return slice(rank * n // world, (rank + 1) * n // world)


class _AllSum(torch.autograd.Function):
    """SUM all-reduce inside autograd: y = sum over ranks of x, so each
    rank's dL/dx is the sum over ranks of their dL/dy (the same SUM)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_sum(x: torch.Tensor, group: DataGroup | None) -> torch.Tensor:
    """x summed over the ranks, differentiably (the batch statistics of
    sync-BN): the gradient of each rank's input is the sum of the ranks'
    output gradients. x itself without a group."""
    if group is None:
        return x
    return _AllSum.apply(x, group.group)


@torch.no_grad()
def global_sum(x, group: DataGroup | None):
    """x (a tensor, or a number such as a count) summed over the ranks,
    outside autograd (a global-batch denominator, a logged loss term); x
    itself without a group."""
    if group is None:
        return x
    if torch.is_tensor(x):
        out = x.detach().clone()
    else:
        out = torch.tensor(float(x), device=group.device)
    dist.all_reduce(out, group=group.group)
    return out
