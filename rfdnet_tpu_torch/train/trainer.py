"""Training runtime: Adam written out as optax computes it (one kernel
launch a step on the card), per-module optimizer overrides, freezing, the
train and eval steps, the plateau LR schedule.

Counterpart of `rfdnet_tpu/train/trainer.py`. `make_optimizer` there is
`optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps))` at
unit LR, and the step applies p - lr * scale * u to the parameters that
are not frozen: torch Adam's coupled L2, with optax's order of operations
(moments, then the bias corrections 1 - b^t in f32, then eps outside the
square root). The LR and the BN momentum are plain numbers of the step,
so the host-side schedules change them freely. On the card the update of
every leaf is one launch of the multi-tensor kernel `csrc/adam.cu`
(`Adam`); on the CPU it runs in plain torch, with the same roundings.

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

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..collectives import global_sum
from ..ops import _native
from ..parallel.mesh import all_reduce_grads
from ..utils.profiling import count, span


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


# the step's scalars of a spec, in the order of `Spec` in `csrc/adam.cu`
# (padded to 12 f32 there)
SCALARS = ("wd", "one_minus_b1", "b1", "one_minus_b2", "b2", "c1", "c2",
           "eps", "coef")


def step_scalars(groups, step: int, lr: float) -> torch.Tensor:
    """(len(groups), 12) f32 on the host: each `AdamSpec`'s scalars of
    step `step` (from 1) at `lr`, in the order of `SCALARS` and 0 after
    them, each computed once in f32 as optax computes it: the betas, 1 -
    beta, eps and the weight decay rounded to f32, c1 = 1 - b1^t and c2 =
    1 - b2^t in f32, coef = (-lr) * lr_scale in f32."""
    one = torch.ones((), dtype=torch.float32)
    rows = torch.zeros((len(groups), 12), dtype=torch.float32)
    for k, s in enumerate(groups):
        b1, b2 = s.betas
        rows[k, :len(SCALARS)] = torch.stack([
            one * s.weight_decay, one * (1 - b1), one * b1, one * (1 - b2),
            one * b2, 1 - (b1 * one) ** step, 1 - (b2 * one) ** step,
            one * s.eps, (-lr * one) * s.lr_scale])
    return rows


@torch.no_grad()
def adam_update_plain(params, grads, mu, nu, spec_index, groups, step: int,
                      lr: float) -> None:
    """One Adam update in plain torch, a leaf at a time, on any device:
    the arithmetic of `csrc/adam.cu`, an op per rounding. Leaf i (its
    parameter, gradient and moments, updated in place) takes the spec
    `groups[spec_index[i]]`; `step` counts from 1."""
    if not params:
        return
    scalars = step_scalars(groups, step, lr).to(params[0].device)
    rows = [r.unbind() for r in scalars]
    for p, g, m, v, k in zip(params, grads, mu, nu, spec_index):
        wd, omb1, b1, omb2, b2, c1, c2, eps, coef = rows[k][:len(SCALARS)]
        if groups[k].weight_decay:
            g = g + wd * p
        m.copy_(omb1 * g + b1 * m)
        v.copy_(omb2 * (g * g) + b2 * v)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.add_(coef * u)


@functools.cache
def _adam_lib():
    lib = _native.load("adam")
    lib.rfd_adam_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                    + [ctypes.c_void_p])
    lib.rfd_adam_launch.restype = ctypes.c_int
    lib.rfd_adam_chunk.argtypes = []
    lib.rfd_adam_chunk.restype = ctypes.c_int
    return lib


def adam_table(params, grads, mu, nu, spec_index, groups, step: int,
               lr: float, chunk: int, alloc=None) -> tuple:
    """The table that `csrc/adam.cu` reads (its layout is described there)
    for one update: every leaf's addresses, element count, first chunk
    and spec; each spec's `step_scalars`; each chunk's leaf, with `chunk`
    elements a chunk. `alloc(words)` gives the int64 host tensor it is
    written into (a new one by default). Returns (table, chunks)."""
    n = np.array([p.numel() for p in params], dtype=np.int64)
    chunks = -(-n // chunk)
    n_leaves, n_chunks = len(params), int(chunks.sum())
    spec_words = 8 * n_leaves + 6 * len(groups)
    words = spec_words + (n_chunks + 1) // 2
    out = (alloc or (lambda w: torch.empty(w, dtype=torch.int64)))(words)
    table = out.numpy()
    leaves = table[:8 * n_leaves].reshape(n_leaves, 8)
    for col, tensors in enumerate((params, grads, mu, nu)):
        leaves[:, col] = [t.data_ptr() for t in tensors]
    leaves[:, 4] = n
    leaves[:, 5] = np.cumsum(chunks) - chunks
    leaves[:, 6] = spec_index
    leaves[:, 7] = 0
    table[8 * n_leaves:spec_words].view(np.float32)[:] = step_scalars(
        groups, step, lr).numpy().reshape(-1)
    chunk_leaf = table[spec_words:].view(np.int32)
    chunk_leaf[:n_chunks] = np.repeat(np.arange(n_leaves, dtype=np.int32),
                                      chunks)
    chunk_leaf[n_chunks:] = 0
    return out, n_chunks


def _pinned(words: int) -> torch.Tensor:
    return torch.empty(words, dtype=torch.int64, pin_memory=True)


def adam_update_kernel(params, grads, mu, nu, spec_index, groups, step: int,
                       lr: float) -> None:
    """`adam_update_plain` as one launch of `csrc/adam.cu` for every leaf
    (contiguous f32 CUDA tensors on one card). The `adam_table` is built
    on the host and reaches the card in one copy from pinned memory on
    the current stream: no sync, no launch a leaf. Each step takes a new
    pinned buffer from PyTorch's caching host allocator, which hands a
    block out again only once the copy that read it is done (it records
    an event on the copy's stream), so the host never writes over a table
    still in flight."""
    if not params:
        return
    lib = _adam_lib()
    dev = params[0].device
    host, n_chunks = adam_table(params, grads, mu, nu, spec_index, groups,
                                step, lr, lib.rfd_adam_chunk(), _pinned)
    on_card = host.to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        err = lib.rfd_adam_launch(_native.ptr(on_card), len(params),
                                  len(groups), n_chunks, _native.stream(dev))
    _native.check_launch(err, "adam")
    count("ops.adam.launches")


class Adam:
    """Adam over named parameters, each with the `AdamSpec` of its
    top-level submodule (`spec_of(name)`): for a gradient g,
    g += wd * p; mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu;
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), then
    p += (-lr * lr_scale) * u.

    `step` updates every parameter, `mu` and `nu` in place. On the card
    that is one launch of the multi-tensor kernel `csrc/adam.cu`
    (`adam_update_kernel`; the counter `ops.adam.launches` counts it) over
    a table of every leaf's addresses and spec, rebuilt each step since
    autograd allocates new gradients; on the CPU it is
    `adam_update_plain`, the same arithmetic. The distinct specs are
    `groups` (`spec_index[i]` is leaf i's), so per-module overrides are
    rows of the table's scalars, computed on the host once a step. Every
    leaf must be a contiguous f32 tensor with a gradient of its shape, on
    the first leaf's device; `step` raises otherwise.

    `mu` and `nu` are lists of per-leaf tensors in the order of `names`,
    allocated once: `state_dict` returns them (not copies) and
    `load_state_dict` copies into them."""

    def __init__(self, named_params, spec_of):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        specs = [spec_of(n.split(".")[0]) for n in self.names]
        self.groups = list(dict.fromkeys(specs))
        self.spec_index = [self.groups.index(s) for s in specs]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _check(self) -> list:
        """Every leaf's gradient, after the checks of the class
        docstring."""
        device = self.params[0].device
        grads = []
        for name, p in zip(self.names, self.params):
            if p.grad is None:
                raise ValueError(f"Adam: {name} has no gradient")
            shape = tuple(p.shape)
            _native.check_tensor(p, f"Adam: {name}", torch.float32, shape,
                                 device)
            _native.check_tensor(p.grad, f"Adam: {name}.grad", torch.float32,
                                 shape, device)
            grads.append(p.grad)
        return grads

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update of every parameter from its `.grad`; a refused
        step changes nothing."""
        if not self.params:
            self.count += 1
            return
        grads = self._check()
        self.count += 1
        update = (adam_update_plain if self.params[0].device.type == "cpu"
                  else adam_update_kernel)
        update(self.params, grads, self.mu, self.nu, self.spec_index,
               self.groups, self.count, lr)

    def state_dict(self) -> dict:
        return {"count": self.count,
                **{f"mu/{n}": m for n, m in zip(self.names, self.mu)},
                **{f"nu/{n}": v for n, v in zip(self.names, self.nu)}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key, moments in (("mu", self.mu), ("nu", self.nu)):
            for n, m in zip(self.names, moments):
                src = torch.as_tensor(state[f"{key}/{n}"])
                if src.shape != m.shape:
                    raise ValueError(f"Adam: {key}/{n} has shape "
                                     f"{tuple(src.shape)}, expected "
                                     f"{tuple(m.shape)}")
                m.copy_(src)


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
    The gradients are set to None first, so the backward allocates new
    ones; `Adam.step` then updates the parameters and its moments in
    place, on the card in one kernel launch over a table of the step's
    gradient addresses (no sync). Returns the loss terms, detached.
    Spans: the root `train.step` over `train.forward`, `train.loss`,
    `train.backward` and `train.adam` (the gradients' all-reduce lies
    between the last two)."""
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
