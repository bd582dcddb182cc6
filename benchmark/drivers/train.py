"""Train steps through the port's `rfdnet_tpu_torch.train.trainer.
train_step` (the training forward in train mode, `ISCNet.loss`, backward,
the port's Adam) at the configuration's batch, in a loop: each step's
batch is copied from pinned host memory to the card as the loader hands
it over, its posterior noise is drawn on the card from the seed, and its
loss terms come back to the host (as the trainer's loop logs them).

Traffic keys: `batch`, `distinct_batches` (batches made from the seed and
cycled), `num_objects`, `num_obj_points` (occupancy points an object, the
loader's `points_subsample` summed), `checked_steps` (the first steps,
which are also the warm-up, compared with the reference), `trace_steps`.

The first `checked_steps` steps run in set-up, through the same call and
feed as the window's, on batches that all differ; the window goes on with
the same model and optimizer. What they give is compared once the window
has closed: each step's total loss, the first gradient as the optimizer
got it (its first moment after one step over 1 - b1), and the
parameters' change after the checked steps."""

from __future__ import annotations

import time

import numpy as np
import torch

import rfdref
from rfdbench import compare, scenes, trace, weights
from rfdref import config as refconfig
from rfdref import train as reftrain
from rfdref.models.common import set_bn_momentum as ref_bn_momentum

# the SA1-SA4 FPS calls of the backbone and the proposals' seed_fps over
# SA2's 1024 points: (points in, samples) at 80000 points a scene
FPS_CALLS = ((80000, 2048), (2048, 1024), (1024, 512), (512, 256),
             (1024, 256))


def bn_momentum(cfg: dict, epoch: int = 0) -> float:
    """The BN-momentum schedule at `epoch`: max(init * rate^(epoch //
    step), floor)."""
    bs = cfg["bnscheduler"]
    return max(bs["bn_momentum_init"]
               * bs["bn_decay_rate"] ** int(epoch / bs["bn_decay_step"]),
               bs["bn_momentum_max"])


def make_batches(ctx) -> list:
    """The `distinct_batches` batches with every GT field of the loader,
    pinned on the host."""
    tr, cfg = ctx.traffic, ctx.config["config"]
    rng = np.random.RandomState(ctx.seed % 2 ** 32)
    pin = torch.device(ctx.device).type == "cuda"
    out = []
    for _ in range(tr["distinct_batches"]):
        b = scenes.synthetic_scene_batch(
            rng, batch_size=tr["batch"], num_points=cfg["data"]["num_point"],
            num_objects=tr["num_objects"],
            num_obj_points=tr["num_obj_points"],
            mean_size_arr=refconfig.MEAN_SIZE_ARR)
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        out.append({k: v.pin_memory() if pin else v for k, v in b.items()})
    return out


def noise(ctx, steps: int, rows: int):
    """The posterior noise of the first `steps` steps, (rows, z_dim)
    each, from a generator on the device seeded with the run's seed."""
    g = torch.Generator(device=ctx.device).manual_seed(
        (ctx.seed + 7) % 2 ** 63)
    z = ctx.config["config"]["data"]["z_dim"]
    return g, [torch.randn((rows, z), generator=g, device=ctx.device)
               for _ in range(steps)]


def optimizer_settings(cfg: dict) -> dict:
    """The configuration's Adam; per-module overrides and frozen modules
    are not part of the configurations this driver runs."""
    if cfg["train"].get("freeze") or any(
            isinstance(v, dict) and "optimizer" in v
            for v in cfg.get("model", {}).values()):
        raise ValueError("train driver: freezing and per-module optimizer "
                         "settings are not supported")
    opt = cfg["optimizer"]
    return dict(betas=tuple(opt["betas"]), eps=float(opt["eps"]),
                weight_decay=float(opt["weight_decay"]))


class Run:
    def __init__(self, ctx):
        from rfdnet_tpu_torch import config as pconfig
        from rfdnet_tpu_torch.models.common import set_bn_momentum
        from rfdnet_tpu_torch.train import trainer

        self.ctx, self.dev = ctx, ctx.device
        cfg, tr = ctx.config["config"], ctx.traffic
        self.trainer = trainer
        self.lr = float(cfg["optimizer"]["lr"])
        self.weight = float(cfg["model"]["completion"]["weight"])
        self.settings = optimizer_settings(cfg)
        self.batches = make_batches(ctx)
        model = pconfig.build_model(
            pconfig.load_config(cfg, mode="train"),
            generate_limit=ctx.config["generate_limit"], device=self.dev,
            mode="train")
        start = weights.for_run(ctx, "train")
        model.load_state_dict(start)
        set_bn_momentum(model, bn_momentum(cfg))
        self.model = model
        self.opt = trainer.Adam(
            trainer.freeze(model, ()),
            trainer.make_optimizer_with_specs(cfg["optimizer"],
                                              cfg.get("model", {})))
        self.rows = tr["batch"] * model.completion_limit
        self.gen, self.checked_eps = noise(ctx, tr["checked_steps"],
                                           self.rows)
        self.steps = 0
        ctx.info = {"fps_calls": FPS_CALLS}
        # the checked steps: also the warm-up
        b1 = self.settings["betas"][0]
        losses = []
        for i in range(tr["checked_steps"]):
            losses.append(self.step(self.checked_eps[i])["total"])
            if i == 0:
                grad = {n: m / (1 - b1) for n, m in
                        zip(self.opt.names, self.opt.mu)}
                grad = compare.leaf_norms(grad)
        change = compare.leaf_norms({n: p.detach() - start[n] for n, p in
                                     zip(self.opt.names, self.opt.params)})
        self.got = {"losses": losses, "grad": grad, "change": change}
        del start

    def step(self, eps=None) -> dict:
        """One step on the next batch: the batch to the card, the step,
        the loss terms on the host."""
        host = self.batches[self.steps % len(self.batches)]
        batch = {k: v.to(self.dev, non_blocking=True)
                 for k, v in host.items()}
        if eps is None:
            eps = torch.randn((self.rows, self.checked_eps[0].shape[1]),
                              generator=self.gen, device=self.dev)
        losses = self.trainer.train_step(self.model, self.opt, batch,
                                         self.lr, self.weight, eps=eps)
        keys = sorted(losses)
        values = torch.stack([losses[k].float() for k in keys]).tolist()
        self.steps += 1
        return dict(zip(keys, values))

    def window(self, seconds: float) -> dict:
        n = 0
        start = time.perf_counter()
        while True:
            self.step()
            n += 1
            done = time.perf_counter()
            if done - start >= seconds:
                break
        elapsed = done - start
        return {"units": n, "window_s": elapsed, "attempted": n,
                "failed": 0, "train_samples_per_s":
                    n * self.ctx.traffic["batch"] / elapsed}

    def traced(self):
        return trace.profile_units(self.step, self.ctx.traffic["trace_steps"],
                                   self.dev)

    def release(self) -> None:
        self.model = self.opt = None

    def reference(self, tf32: bool = False,
                  count_flops: bool = False) -> dict:
        """The reference's checked steps from the same weights, batches
        and noise (in TF32 with `tf32`): its losses, first gradient and
        change, as `self.got` holds the program's."""
        ctx = self.ctx
        cfg = ctx.config["config"]
        ref = refconfig.build_model(cfg, "train", ctx.config["generate_limit"],
                                    self.dev)
        start = weights.for_run(ctx, "train")
        ref.load_state_dict(start)
        ref_bn_momentum(ref, bn_momentum(cfg))
        opt = reftrain.Adam(reftrain.trainable(ref), **self.settings)
        b1 = self.settings["betas"][0]
        losses = []
        with rfdref.precision(tf32):
            for i, eps in enumerate(self.checked_eps):
                host = self.batches[i % len(self.batches)]
                batch = {k: v.to(self.dev) for k, v in host.items()}

                def step():
                    return reftrain.train_step(ref, opt, batch, self.lr,
                                               self.weight, eps)
                if count_flops and i == 0:
                    from torch.utils.flop_counter import FlopCounterMode

                    with FlopCounterMode(display=False) as counter:
                        out = step()
                    ctx.flops_per_unit = counter.get_total_flops()
                else:
                    out = step()
                losses.append(float(out["total"]))
                if i == 0:
                    grad = compare.leaf_norms(
                        {n: m / (1 - b1) for n, m in zip(opt.names, opt.mu)})
        change = compare.leaf_norms({n: p.detach() - start[n] for n, p in
                                     zip(opt.names, opt.params)})
        return {"losses": losses, "grad": grad, "change": change}

    def check(self, count_flops: bool = False,
              control: bool = False) -> dict:
        """The program's checked steps against the reference's. With
        `control`, also the reference in TF32 against it
        (`self.control_readings`)."""
        expected = self.reference(count_flops=count_flops)
        self.expected = expected
        if control:
            self.control_expected = self.reference(tf32=True)
            self.control_readings = compare.trained(self.control_expected,
                                                    expected)
        return compare.trained(self.got, expected)
