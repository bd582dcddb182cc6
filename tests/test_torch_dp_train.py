"""The port's data-parallel train step (`trainer.train_step` with the
model's data group: sync-BN, the global-batch loss, the SUM all-reduce
of the gradients) on the smooth toy of `tests/test_train.py` at 2 and 4
gloo ranks on the CPU, against its own one-process step and JAX's step
sharded over its 8-device virtual mesh, at 1e-6; and the pieces of a
data-parallel run: `pick_world`, `shard_batch`, the loader's rank rows,
`replicated_check` and `broadcast_module`.

The real model's steps are in `test_torch_dp_train_detection.py` (2
ranks), `_detection_world4.py` (4 ranks) and `_pinned.py` (the completion
model with pinned selections).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfdnet_tpu.train import trainer as jtrainer
from rfdnet_tpu_torch.collectives import shard_rows
from rfdnet_tpu_torch.data.scannet import DataLoader
from rfdnet_tpu_torch.parallel.mesh import rank_device, shard_batch
from rfdnet_tpu_torch.train.loop import pick_world
from torch_parity import (assert_close, jax_sharded_step, port_state,
                          running_stats)
import torch_dist

WORLDS = (2, 4)


def _runs(spec):
    """{world: rank results} for the one-process step (world 1) and each
    of WORLDS."""
    out = {1: [torch_dist.train_step_rank(None, spec)]}
    for w in WORLDS:
        out[w] = torch_dist.run(torch_dist.train_step_rank, w, spec)
    return out


# ---------------------------------------------------------------- toy model
class _JaxToyNet:
    """`tests/test_train.py`'s `_ToyNet`: Dense(32, no bias) -> BatchNorm
    -> ReLU -> Dense(1), mean squared error."""

    def __new__(cls):
        import flax.linen as nn

        from rfdnet_tpu.models.common import BatchNorm

        class Net(nn.Module):
            @nn.compact
            def __call__(self, batch, train, bn_momentum=None, rng=None):
                h = nn.Dense(32, use_bias=False)(batch["x"])
                h = BatchNorm(name="bn")(h, train, bn_momentum)
                return nn.Dense(1)(nn.relu(h))

            def loss(self, out, batch, dataset_config, completion_weight):
                return {"total": jnp.mean((out - batch["y"]) ** 2)}

        return Net()


@pytest.fixture(scope="module")
def toy():
    import optax

    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(64, 16).astype(np.float32),
             "y": rng.randn(64, 1).astype(np.float32)}
    model = _JaxToyNet()
    tx = optax.identity()  # param delta == -gradient at lr 1
    state = jtrainer.init_state(model, tx, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    new, losses = jax_sharded_step(model, None, tx, variables, batch,
                                   jax.random.PRNGKey(1), 1.0, 0.5)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   variables["params"], new.params)
    jax_out = dict(total=float(losses["total"]),
                   grads=port_state({"params": grads}),
                   stats=running_stats(port_state(
                       {"params": new.params,
                        "batch_stats": new.batch_stats})))
    spec = dict(cfg=None, state=port_state(variables), batch=batch, lr=1.0,
                bn_momentum=0.5)
    return jax_out, _runs(spec)


def test_dp_toy_exact(toy):
    jax_out, runs = toy
    one = runs[1][0]
    for w in WORLDS:
        for r in runs[w]:
            assert r["losses"]["total"] == pytest.approx(
                one["losses"]["total"], rel=1e-6)
            for name, g in one["grads"].items():
                assert_close(r["grads"][name], g, atol=1e-6, rtol=1e-5,
                             what=f"world {w}: grad {name}")
            for name, s in running_stats(one["state"]).items():
                assert_close(r["state"][name], s, atol=1e-6, rtol=1e-5,
                             what=f"world {w}: {name}")
            # Adam ran the same update on every rank
            for name, p in r["state"].items():
                assert_close(p, runs[w][0]["state"][name], atol=0, rtol=0)
    for w in (1, *WORLDS):
        r = runs[w][0]
        assert r["losses"]["total"] == pytest.approx(jax_out["total"],
                                                     rel=1e-6)
        for name, g in jax_out["grads"].items():
            assert_close(r["grads"][name], g, atol=1e-6, rtol=1e-5,
                         what=f"world {w}: grad {name} against JAX")
        for name, s in jax_out["stats"].items():
            assert_close(r["state"][name], s, atol=1e-6, rtol=1e-5,
                         what=f"world {w}: {name} against JAX")


# ------------------------------------------------------- run's pieces
@pytest.mark.parametrize("batch,cards,world", [
    (8, 1, 1), (8, 4, 4), (8, 3, 2), (8, 0, 1), (6, 4, 3), (7, 8, 7),
    (8, 16, 8)])
def test_pick_world(batch, cards, world):
    """The largest count of cards that divides the batch, as `pick_mesh`
    picks devices."""
    assert pick_world(batch, cards) == world


class _GroupStub:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world


def test_shard_batch_rows():
    batch = {"x": np.arange(24).reshape(8, 3), "names": list("abcdefgh")}
    assert shard_batch(batch, None) is batch
    for world in (1, 2, 4, 8):
        parts = [shard_batch(batch, _GroupStub(r, world))
                 for r in range(world)]
        assert [len(p["names"]) for p in parts] == [8 // world] * world
        np.testing.assert_array_equal(
            np.concatenate([p["x"] for p in parts]), batch["x"])
        assert sum((p["names"] for p in parts), []) == batch["names"]
    assert [shard_rows(5, r, 2) for r in (0, 1)] == [slice(0, 2),
                                                     slice(2, 5)]


class _Items:
    """A dataset of n items, each its own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("n,world", [(19, 2), (16, 4), (24, 8)])
def test_loader_rank_rows_are_the_global_batch(n, world):
    """Each rank's loader yields its rows of the one-process loader's
    global batches (shuffled at the same seed and epoch), in order."""
    kw = dict(shuffle=True, num_workers=1, seed=3, worker_type="thread")
    whole = DataLoader(_Items(n), 8, **kw)
    whole.set_epoch(2)
    ranks = [DataLoader(_Items(n), 8, shard=(r, world), **kw)
             for r in range(world)]
    for loader in ranks:
        loader.set_epoch(2)
        assert len(loader) == len(whole)
    for i, (want, *got) in enumerate(zip(whole, *ranks)):
        assert whole.batch_rows(i) == len(want["i"])
        np.testing.assert_array_equal(
            np.concatenate([g["i"] for g in got]), want["i"])


def test_loader_refuses_a_batch_smaller_than_the_world():
    loader = DataLoader(_Items(19), 8, num_workers=1, worker_type="thread",
                        shard=(0, 4))
    with pytest.raises(ValueError, match="4 ranks"):
        list(loader)


def test_replicated_check_and_broadcast():
    """`replicated_check` raises on the rank whose parameters differ from
    rank 0's; after `broadcast_module` every rank passes it."""
    res = torch_dist.run(torch_dist.replicated_rank, 2)
    assert res == [{"before": None, "after": None},
                   {"before": "1 tensors differ", "after": None}]


def test_rank_device_needs_a_card_unless_the_cpu_is_asked_for():
    assert rank_device(3, "cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(0)
