"""Training runtime: Adam written out as optax computes it, per-module
optimizer overrides, freezing, the train and eval steps, the plateau LR
schedule.

Counterpart of `rfdnet_tpu/train/trainer.py`. `make_optimizer` there is
`optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps))` at
unit LR, and the step applies p - lr * scale * u to the parameters that
are not frozen: torch Adam's coupled L2, with optax's order of operations
(moments, then the bias corrections 1 - b^t in f32, then eps outside the
square root). The LR and the BN momentum are plain numbers of the step,
so the host-side schedules change them freely.

Frozen submodules (`train.freeze`) get no update, as there. Here they get
no gradient either: their parameters do not require one, so autograd
leaves out what only they would need (the JAX package computes their
gradients and Adam moments and masks the update; the parameters that
train come out the same).

Data parallel (the model's `data_group`, a `collectives.DataGroup` that
`common.set_data_group` gives it; `make_train_step(mesh=)` there): each
rank holds its rows of the global batch, the batch norms take the global
batch's statistics and the loss terms are the global batch's parts, so
the sum of the ranks' gradients, all-reduced before `Adam.step`, is the
global loss's gradient, and Adam runs the same update on every rank. The loss terms returned are
the global ones (the parts summed over the ranks). DDP is not used: its
mean of per-rank gradients is another loss, and the frozen modules'
parameters, which need no gradient, are simply not in the all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..collectives import global_sum
from ..parallel.mesh import all_reduce_grads
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """One parameter group's Adam: betas, eps, L2 weight decay, and its
    LR as a multiple of the schedule's."""

    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    lr_scale: float = 1.0


def make_optimizer_with_specs(base: dict, model_cfg: dict):
    """Per-submodule optimizer overrides: a nested `optimizer` key under
    `model.<submodule>` overrides betas/eps/weight_decay for that
    submodule, and its `lr` becomes an LR scale (lr / base lr) so that the
    plateau schedule still acts on every group. Returns a function from a
    top-level submodule's name to its `AdamSpec`."""
    base_lr = base.get("lr", 1e-3)

    def spec(section: dict, lr_scale: float) -> AdamSpec:
        return AdamSpec(
            tuple(section.get("betas", base.get("betas", (0.9, 0.999)))),
            float(section.get("eps", base.get("eps", 1e-8))),
            float(section.get("weight_decay", base.get("weight_decay", 0.0))),
            float(lr_scale))

    default = spec({}, 1.0)
    specs = {name: spec(sub["optimizer"],
                        sub["optimizer"].get("lr", base_lr) / base_lr)
             for name, sub in (model_cfg or {}).items()
             if isinstance(sub, dict) and "optimizer" in sub}
    return lambda name: specs.get(name, default)


def freeze(model: nn.Module, frozen) -> list:
    """Turn off the gradients of the top-level submodules named in
    `frozen` and on those of the rest. Returns [(name, parameter)] of the
    parameters that train."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] not in frozen)
        if p.requires_grad:
            trainable.append((name, p))
    return trainable


class Adam:
    """Adam over named parameters, each with the `AdamSpec` of its
    top-level submodule (`spec_of(name)`): for a gradient g,
    g += wd * p; mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu;
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), then
    p += (-lr * lr_scale) * u."""

    def __init__(self, named_params, spec_of):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.specs = [spec_of(n.split(".")[0]) for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update of every parameter from its `.grad`."""
        self.count += 1
        if not self.params:
            return
        # f32 scalars, as optax's 1 - b^t and the step's -lr
        one = torch.ones((), dtype=torch.float32,
                         device=self.params[0].device)
        for i, (p, s) in enumerate(zip(self.params, self.specs)):
            g = p.grad
            if s.weight_decay:
                g = g + s.weight_decay * p
            b1, b2 = s.betas
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * g ** 2 + b2 * self.nu[i]
            corr1 = 1 - (b1 * one) ** self.count
            corr2 = 1 - (b2 * one) ** self.count
            u = (self.mu[i] / corr1) / (torch.sqrt(self.nu[i] / corr2) + s.eps)
            coef = (-lr * one) * s.lr_scale
            p.add_(coef * u)

    def state_dict(self) -> dict:
        return {"count": self.count,
                **{f"mu/{n}": m for n, m in zip(self.names, self.mu)},
                **{f"nu/{n}": v for n, v in zip(self.names, self.nu)}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.mu[i] = torch.as_tensor(state[f"mu/{n}"]).to(self.mu[i])
            self.nu[i] = torch.as_tensor(state[f"nu/{n}"]).to(self.nu[i])


def _global_terms(losses: dict, group) -> dict:
    """The loss terms, detached, summed over the ranks (one all-reduce)."""
    losses = {k: v.detach() for k, v in losses.items()}
    if group is None:
        return losses
    keys = sorted(losses)
    summed = global_sum(torch.stack([losses[k].float() for k in keys]),
                        group)
    return dict(zip(keys, summed.unbind()))


def train_step(model, optimizer: Adam, batch: dict, lr: float,
               completion_weight: float = 1.0, eps=None,
               generator=None) -> dict:
    """One step in train mode: forward, loss, backward, Adam. `eps` /
    `generator`: the posterior noise (see `ISCNet.forward`; with a data
    group, this rank's rows of it). With a `model.data_group`, `batch`
    is this rank's rows of a global batch, see the module docstring.
    Returns the loss terms, detached. Spans: the root `train.step` over
    `train.forward`, `train.loss`, `train.backward` and `train.adam`
    (the gradients' all-reduce lies between the last two)."""
    with span("train.step"):
        group = model.data_group
        for p in optimizer.params:
            p.grad = None
        model.train()
        with span("train.forward"):
            out = model(batch, eps=eps, generator=generator)
        with span("train.loss"):
            losses = model.loss(out, batch, completion_weight)
        with span("train.backward"):
            losses["total"].backward()
        all_reduce_grads(optimizer.params, group)
        with span("train.adam"):
            optimizer.step(lr)
        return _global_terms(losses, group)


@torch.no_grad()
def eval_step(model, batch: dict, completion_weight: float = 1.0,
              generator=None) -> dict:
    """The loss terms of `batch` in eval mode (running statistics, the
    posterior mean z, the fused decoder). `generator` feeds `random`
    sampling only. With a `model.data_group`, the global batch's terms,
    as in `train_step`."""
    model.eval()
    out = model(batch, generator=generator)
    return _global_terms(model.loss(out, batch, completion_weight),
                         model.data_group)


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (mode min, relative threshold): the LR is
    multiplied by `factor` once the metric has not improved on its best
    by `threshold` for more than `patience` epochs."""

    lr: float
    factor: float = 0.1
    patience: int = 20
    threshold: float = 0.01
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr
