"""Weights for the port: the bridge from `rfdnet_tpu`'s flax variables
(in memory, or as the flat `.npz` that `tools/export_torch_weights.py`
writes from a checkpoint of the JAX package, and that the port's trainer
writes too, `flax_flat`), and a seeded init of the port's own.

Module names in the port follow the flax tree, so the bridge is a rename:
- Dense `kernel` (in, out) -> `weight` (out, in), `bias` -> `bias`;
- BatchNorm `scale`/`bias` -> `weight`/`bias`, and its `batch_stats`
  `mean`/`var` -> `running_mean`/`running_var`;
- CBatchNorm `gamma_kernel`/`gamma_bias` -> `gamma.weight`/`gamma.bias`,
  `beta_kernel`/`beta_bias` -> `beta.weight`/`beta.bias`, and the stats of
  its `_AffinelessBatchNorm` (`bn`) -> `bn.running_mean`/`bn.running_var`;
- SelfAttention's `gamma` -> `gamma` (its `query`/`key`/`value` are Dense;
  SetAbstractionMSG's branches are SharedMLPs `mlp0`, `mlp1`, ...).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.common import BatchNorm, Dense
from .models.layers import (
    CBatchNorm,
    EncoderLatent,
    SelfAttention,
    _AffinelessBatchNorm,
)

_PARAM_LEAVES = {
    "kernel": ("weight", True),
    "bias": ("bias", False),
    "scale": ("weight", False),
    "gamma_kernel": ("gamma.weight", True),
    "gamma_bias": ("gamma.bias", False),
    "beta_kernel": ("beta.weight", True),
    "beta_bias": ("beta.bias", False),
    "gamma": ("gamma", False),   # SelfAttention's gate
}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables) -> dict[str, torch.Tensor]:
    """Map flax variables (a nested dict of arrays with `params` and
    `batch_stats`) to the port's `state_dict` keys."""
    out = {}
    for path, leaf in _walk(variables["params"]):
        name, transpose = _PARAM_LEAVES[path[-1]]
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        out[".".join(path[:-1] + (name,))] = t.T.contiguous() if transpose else t
    for path, leaf in _walk(variables.get("batch_stats", {})):
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        out[".".join(path[:-1] + (_STAT_LEAVES[path[-1]],))] = t
    return out


@torch.no_grad()
def flax_flat(model: nn.Module) -> dict[str, np.ndarray]:
    """The inverse of `from_flax`: the model's parameters and running
    statistics as a flat dict of flax paths (`params/<module>/.../kernel`,
    `batch_stats/<module>/.../mean`), the layout of `load_npz`."""
    out = {}
    inside_cbn = {id(d) for m in model.modules() if isinstance(m, CBatchNorm)
                  for d in (m.gamma, m.beta)}

    def put(kind, prefix, leaf, t, transpose=False):
        t = t.detach().cpu()
        out["/".join((kind, *prefix, leaf))] = (
            t.T if transpose else t).contiguous().numpy()

    for name, m in model.named_modules():
        prefix = tuple(name.split(".")) if name else ()
        if isinstance(m, CBatchNorm):
            for part in ("gamma", "beta"):
                dense = getattr(m, part)
                put("params", prefix, f"{part}_kernel", dense.weight, True)
                put("params", prefix, f"{part}_bias", dense.bias)
        elif isinstance(m, Dense) and id(m) not in inside_cbn:
            put("params", prefix, "kernel", m.weight, True)
            if m.bias is not None:
                put("params", prefix, "bias", m.bias)
        elif isinstance(m, SelfAttention):
            put("params", prefix, "gamma", m.gamma)
        elif isinstance(m, (BatchNorm, _AffinelessBatchNorm)):
            if isinstance(m, BatchNorm):
                put("params", prefix, "scale", m.weight)
                put("params", prefix, "bias", m.bias)
            put("batch_stats", prefix, "mean", m.running_mean)
            put("batch_stats", prefix, "var", m.running_var)
    return out


@torch.no_grad()
def partial_load(model: nn.Module, source: dict, log=print) -> nn.Module:
    """Load `source` (state_dict keys -> tensors) into `model` in place, as
    `rfdnet_tpu.train.checkpoint.partial_load`: a tensor of the model is
    loaded when `source` holds its key with its shape and keeps its value
    otherwise; the top-level submodules with a tensor left out are
    reported through `log` ("... subnet missed."), then the ones loaded
    whole."""
    missed, roots = set(), set()
    for key, t in model.state_dict(keep_vars=True).items():
        root = key.split(".")[0]
        roots.add(root)
        s = source.get(key)
        if s is not None and s.shape == t.shape:
            t.copy_(s)
        else:
            missed.add(root)
    if log:
        log(f"{missed or set()} subnet missed.")
        log(f"{sorted(roots - missed)} subnet weights loaded.")
    return model


def read_npz(path: str) -> dict[str, torch.Tensor]:
    """A flat `.npz` of flax paths as state_dict keys -> tensors."""
    tree = {"params": {}, "batch_stats": {}}
    with np.load(path) as npz:
        for key in npz.files:
            parts = key.split("/")
            if parts[0] not in tree or len(parts) < 3:
                raise ValueError(f"{path}: unexpected key {key!r}")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = npz[key]
    return from_flax(tree)


def load_npz(model: nn.Module, path: str, log=print) -> nn.Module:
    """Load a flat `.npz` of flax paths (`params/<module>/.../kernel`,
    `batch_stats/<module>/.../mean`) into `model`, in place, with
    `partial_load`'s report."""
    return partial_load(model, read_npz(path), log)


@torch.no_grad()
def init_seeded(model: nn.Module, seed: int, noise: float = 0.02) -> nn.Module:
    """Fill `model` in place from `seed`, device-independently: the JAX
    package's init (torch-default U(+-1/sqrt(fan_in)) Dense weights and
    biases, zero kernels where it zero-initialises, identity batch norms and
    CBN affines), then N(0, noise^2) added to every parameter and buffer
    (with `noise=0`, the JAX package's init alone: training's start).
    The perturbation matters: at init every fc_1 is zero and every CBN is
    the identity, which would leave the decoder's matmuls untested."""
    g = torch.Generator().manual_seed(seed)
    # the posterior encoder is filled after the rest, init and noise: it is
    # not on the generation path, whose seeded values stay those of a model
    # without it
    late = {name: m for name, m in model.named_modules()
            if isinstance(m, EncoderLatent)}
    inside = {id(sub) for m in late.values() for sub in m.modules()}
    state = model.state_dict(keep_vars=True)
    _fill([m for m in model.modules() if id(m) not in inside],
          {k: t for k, t in state.items()
           if not any(k.startswith(name + ".") for name in late)}, g, noise)
    for m in late.values():
        _fill(list(m.modules()), m.state_dict(keep_vars=True), g, noise)
    return model


def _fill(modules, state: dict, g: torch.Generator, noise: float) -> None:
    """`init_seeded`'s draws over `modules` and their tensors `state`."""
    def fill(t: torch.Tensor, values: torch.Tensor) -> None:
        t.copy_(values.to(t.device))

    for module in modules:
        if isinstance(module, Dense):
            bound = 1.0 / module.in_features ** 0.5
            w = torch.empty(module.weight.shape).uniform_(-bound, bound,
                                                          generator=g)
            fill(module.weight, torch.zeros_like(w) if module.zero_init else w)
            if module.bias is not None:
                fill(module.bias, torch.empty(module.bias.shape).uniform_(
                    -bound, bound, generator=g))
        elif isinstance(module, SelfAttention):
            module.gamma.zero_()
        elif isinstance(module, (BatchNorm, _AffinelessBatchNorm)):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            if isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    # CBN affines start as the identity: gamma = 0 * c + 1, beta = 0 * c + 0
    for module in modules:
        if isinstance(module, CBatchNorm):
            module.gamma.bias.fill_(1.0)
            module.beta.bias.zero_()
    if noise:
        for _, t in sorted(state.items()):
            t.add_(torch.randn(t.shape, generator=g).to(t.device) * noise)
