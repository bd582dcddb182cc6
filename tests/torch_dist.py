"""Rank workers of the port's multi-rank tests (`tests/test_torch_
parallel_serve_ranks.py`, `test_torch_dp_train*.py`, `_point_shard.py`,
`_halo.py`).

`rfdnet_tpu_torch.parallel.mesh.run_ranks` starts each rank in a fresh
process (`spawn`: the test process runs JAX on 8 virtual devices, which
`fork` would copy in an undefined state) and calls one of these
functions there by name, with numpy inputs that the test computed or
made from a seed. This module imports no JAX: the JAX side is computed in
the test process and compared there. A run's ranks share RANK_THREADS
intra-op threads (one a rank at 4 ranks, two at 2), since they share the
machine's cores with the other test processes.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

RANK_THREADS = 4


def run(fn, world: int, *args):
    """fn(group, *args) on `world` gloo ranks on the CPU; the ranks'
    results in rank order."""
    from rfdnet_tpu_torch.parallel.mesh import run_ranks

    return run_ranks(fn, world, "gloo", *args,
                     threads=max(1, RANK_THREADS // world), timeout=600.0)


def start(fn, world: int, *args):
    """`run` in a thread of its own, so that this process can work while
    the ranks run: a future of the ranks' results."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run, fn, world, *args)
    pool.shutdown(wait=False)
    return future


def alone(fn, *args):
    """fn(None, *args): the one-process counterpart of a ranks' run, in
    this process at RANK_THREADS intra-op threads while those ranks (as
    many threads together) run beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        return fn(None, *args)
    finally:
        torch.set_num_threads(threads)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def _block(x: np.ndarray, group) -> torch.Tensor:
    """`group`'s rank's contiguous block of axis 1."""
    n = x.shape[1] // group.world
    return _t(x[:, group.rank * n:(group.rank + 1) * n])


# ------------------------------------------------------------ point shard
def point_shard_rank(group, xyz, feats, idx2, idx3, sa_feats, sa_args,
                     sa_state):
    """Every sharded primitive of `parallel.point_shard` on this rank's
    block of xyz (B, N, 3) / feats (B, N, C), and the sharded SA1 of a
    `SetAbstraction(**sa_args)` with `sa_state` on sa_feats."""
    from rfdnet_tpu_torch.models.pointnet2 import SetAbstraction
    from rfdnet_tpu_torch.parallel import point_shard as ps

    x = _block(xyz, group)
    out = {"fps64": ps.fps_sharded(x, 64, group),
           "fps32_all": ps.fps_sharded(x, 32, group,
                                       skip_near_origin=False)}
    centers = ps.gather_points_sharded(x, out["fps64"], group)
    for radius, ns in [(0.3, 16), (1.5, 8)]:
        out[f"bq_{radius}_{ns}"] = ps.ball_query_sharded(
            x, centers, radius, ns, group)
    far = torch.full((xyz.shape[0], 4, 3), 100.0)
    out["bq_far"] = ps.ball_query_sharded(x, far, 0.2, 8, group)
    f = _block(feats, group)
    out["gather"] = ps.gather_points_sharded(f, _t(idx2), group)
    out["group"] = ps.group_points_sharded(f, _t(idx3), group)
    sa = SetAbstraction(**sa_args)
    sa.load_state_dict({k: _t(v) for k, v in sa_state.items()})
    sa.eval()
    with torch.no_grad():
        out["sa1_xyz"], out["sa1_feat"], out["sa1_inds"] = (
            ps.sa1_forward_sharded(sa, x, _block(sa_feats, group), group))
    return _np(out)


# ------------------------------------------------------------------- halo
def halo_rank(group, xyz_sorted, orig_ids, cidx, radius, nsample, H,
              fps_cases):
    """`ball_query_halo` and each `fps_bucketed` case (name, sorted cloud,
    npoint, k, skip_near_origin) on this rank's slabs."""
    from rfdnet_tpu_torch.parallel import halo

    out = {"bq": halo.ball_query_halo(
        _block(xyz_sorted, group), _block(orig_ids, group), _t(cidx),
        radius, nsample, H, group)}
    for name, cloud, npoint, k, skip in fps_cases:
        out[name] = halo.fps_bucketed(_block(cloud, group), npoint, group,
                                      k=k, skip_near_origin=skip)
    return _np(out)


# ---------------------------------------------------------------- serving
def serve_rank(group, model_kw, state, batch, generate_kw):
    """`make_sharded_generate` over the group: the gathered outputs, as
    this rank holds them, and under "local" this rank's own rows of them
    (its `generate` call before the gather)."""
    from rfdnet_tpu_torch.models import ISCNet
    from rfdnet_tpu_torch.parallel import serve

    model = ISCNet(**model_kw)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    model.eval()
    local = {}
    gather = serve._gather

    def keep_local(tree, g, path=""):
        if not local:  # the outermost call: generate's outputs
            local.update(tree)
        return gather(tree, g, path)

    serve._gather = keep_local
    try:
        out = serve.make_sharded_generate(model, group, **generate_kw)(
            {k: _t(v) for k, v in batch.items()})
    finally:
        serve._gather = gather
    parts = ("grids", "parsed", "gen")
    return _np({**{k: out[k] for k in parts},
                "local": {k: local[k] for k in parts}})


# --------------------------------------------------------------- training
class ToyNet(nn.Module):
    """A model without discrete selections, with the trainer's interface
    (`forward(batch, eps, generator)`, `loss`, `data_group`): bias-free
    Dense -> BatchNorm -> ReLU -> Dense, mean squared error. Names follow
    the flax toy of `tests/test_train.py` (`Dense_0`, `bn`, `Dense_1`)."""

    def __init__(self, features: int = 16, hidden: int = 32):
        super().__init__()
        from rfdnet_tpu_torch.models.common import BatchNorm, Dense

        self.Dense_0 = Dense(features, hidden, bias=False)
        self.bn = BatchNorm(hidden)
        self.Dense_1 = Dense(hidden, 1)
        self.data_group = None

    def forward(self, batch, eps=None, generator=None):
        return self.Dense_1(torch.relu(self.bn(self.Dense_0(batch["x"]))))

    def loss(self, out, batch, completion_weight=1.0):
        from rfdnet_tpu_torch.collectives import global_sum

        err = (out - batch["y"]) ** 2
        return {"total": err.sum() / global_sum(err.numel(),
                                                self.data_group)}


def train_step_rank(group, spec):
    """One `trainer.train_step` on this rank's rows of the global batch
    (`group` None: the whole batch, in this process). spec: cfg (a port
    config dict, or None for `ToyNet`), state (numpy state_dict), batch,
    eps (the global posterior noise or None), lr, bn_momentum, lr_identity
    (an optimizer whose update is the gradient, for the toy). Returns the
    loss terms, the gradients, the state after the step and, with a
    group, the loss terms of a probe whose batch norms sync but whose
    losses divide by this rank's own sums."""
    from rfdnet_tpu_torch import config as tconfig
    from rfdnet_tpu_torch.models.common import set_bn_momentum, set_data_group
    from rfdnet_tpu_torch.collectives import shard_rows
    from rfdnet_tpu_torch.parallel.mesh import shard_batch
    from rfdnet_tpu_torch.train import trainer as ttrainer

    cfg = spec["cfg"]
    model = (ToyNet() if cfg is None
             else tconfig.build_model(cfg, device="cpu", mode="train"))
    model.load_state_dict({k: _t(v) for k, v in spec["state"].items()})
    set_bn_momentum(model, spec["bn_momentum"])
    if cfg is None:
        optimizer = ttrainer.Adam(ttrainer.freeze(model, ()),
                                  lambda name: ttrainer.AdamSpec())
    else:
        from rfdnet_tpu_torch.train.loop import Trainer

        optimizer = Trainer(cfg, model).optimizer
    batch = shard_batch({k: _t(v) for k, v in spec["batch"].items()}, group)
    eps = spec.get("eps")
    if eps is not None:
        eps = _t(eps)
        if group is not None:
            B = len(spec["batch"][next(iter(spec["batch"]))])
            rows = shard_rows(B, group.rank, group.world)
            P = eps.shape[0] // B
            eps = eps[rows.start * P:rows.stop * P]
    out = {}
    if group is not None and cfg is not None:
        probe = copy.deepcopy(model)
        set_data_group(probe, group)
        for m in probe.modules():  # the losses alone divide per rank
            if hasattr(m, "data_group") and not hasattr(m, "running_mean"):
                m.data_group = None
        probe.train()
        with torch.no_grad():
            local = probe.loss(probe(batch, eps=eps), batch)
        out["per_rank"] = {k: float(v) for k, v in local.items()}
    set_data_group(model, group)
    losses = ttrainer.train_step(model, optimizer, batch, spec["lr"],
                                 spec.get("completion_weight", 1.0),
                                 eps=eps)
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["grads"] = {n: p.grad.numpy().copy() for n, p in
                    zip(optimizer.names, optimizer.params)}
    out["state"] = _np(model.state_dict())
    return out


def replicated_rank(group):
    """`replicated_check` on a small module whose parameters rank 1 moves,
    before and after `broadcast_module`: each call's error message (its
    first words), None where it passed."""
    from rfdnet_tpu_torch.parallel.mesh import (broadcast_module,
                                                replicated_check)

    torch.manual_seed(0)
    module = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))
    if group.rank == 1:
        with torch.no_grad():
            module[0].bias[1] += 1e-7
    out = {}
    for when in ("before", "after"):
        try:
            replicated_check(module, group)
            out[when] = None
        except AssertionError as e:
            out[when] = str(e).split(": ", 1)[1].split(" from")[0]
        broadcast_module(module, group)
    return out


def train_rank(group, cfg):
    """`cli.rank_summary` (the CLI's train mode on one rank) on the CPU;
    TensorBoard's import is left out, as in the test process (`LogBoard`
    keeps its JSONL file)."""
    import sys

    sys.modules["torch.utils.tensorboard"] = None
    from rfdnet_tpu_torch import cli

    return cli.rank_summary(group, cfg)
