"""The epoch loop: a train pass and a val pass each epoch, the plateau LR
schedule on the val loss, the BN-momentum schedule, best/last
checkpoints.

Counterpart of `rfdnet_tpu/train/loop.py` (`Trainer`, `run_epoch`,
`train`). Each train step draws its posterior noise from a generator of
its own, seeded from (seed, epoch, phase, step): the stand-in for the JAX
package's `fold_in` key chain, so a step's draw depends on nothing but
its place in the run. `Trainer.step_times` keeps, for each step, the
wait for the loader, the host's time for the step (queueing it and
reading its losses back) and, on a CUDA card, its device time.

Data parallel (`group`, a `collectives.DataGroup`; `pick_mesh` and
the sharded steps there): one process a rank, `pick_world` ranks. Each
rank's loader reads its rows of each global batch (`DataLoader(shard=)`:
the single-process loader's global batch at the same seed, cut into
rank-ordered rows), the steps take the global batch's statistics, losses
and gradient sum (`trainer.train_step`), and each train step's posterior
noise is the global draw of `step_generator`, of which a rank takes its
rows. Only rank 0 holds the checkpoints, the log board and the
visualizations; a resumed or finetuned run broadcasts rank 0's state.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import bn_momentum
from ..collectives import shard_rows
from ..models.common import set_bn_momentum, set_data_group
from ..parallel.mesh import (broadcast_module, broadcast_tensors,
                             replicated_check)
from ..utils.logging import LogBoard, LossRecorder
from .checkpoint import CheckpointIO
from .trainer import (
    Adam,
    PlateauScheduler,
    eval_step,
    freeze,
    make_optimizer_with_specs,
    train_step,
)

# batch fields that stay on the host
_HOST_ONLY = ("object_voxels", "shapenet_catids", "shapenet_ids")
_PHASES = {"train": 0, "val": 1}


def to_device(batch: dict, device) -> dict:
    """The array fields of a loader batch as tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()
            if not isinstance(v, list) and k not in _HOST_ONLY}


def step_generator(seed: int, epoch: int, phase: str, step: int,
                   device) -> torch.Generator:
    """A generator on `device` seeded from (seed, epoch, phase, step)."""
    state = np.random.SeedSequence(
        [seed, epoch, _PHASES[phase], step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def pick_world(batch_size: int, n_cards: int) -> int:
    """The ranks a run takes: the largest count of cards, at most
    `n_cards`, that divides the batch size."""
    n = max(1, n_cards)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


class Trainer:
    """The optimizer, schedules and steps of one training stage, on this
    process's rank of `group` (None: the whole batch), which it sets on
    the model (`common.set_data_group`) for the run."""

    def __init__(self, cfg: dict, model, log=print, save_path=None,
                 group=None):
        self.cfg = cfg
        self.model = model
        self.log = log
        self.save_path = save_path
        self.group = group
        set_data_group(model, group)
        opt = cfg["optimizer"]
        self.frozen = tuple(cfg["train"].get("freeze", []))
        self.optimizer = Adam(
            freeze(model, self.frozen),
            make_optimizer_with_specs(opt, cfg.get("model", {})))
        sch = cfg["scheduler"]
        self.plateau = PlateauScheduler(
            lr=opt["lr"], factor=sch.get("factor", 0.1),
            patience=sch.get("patience", 20),
            threshold=sch.get("threshold", 0.01))
        self.completion_weight = (cfg.get("model", {}).get("completion")
                                  or {}).get("weight", 1.0)
        self.device = next(model.parameters()).device
        self.seed = cfg.get("seed", 10)
        self.step_times: list[dict] = []

    def visualize_step(self, batch: dict, epoch: int, phase: str, it: int):
        """Dump predicted and GT 16^3 voxel snapshots of `batch` (an eval
        forward with the shapes exported; in a data-parallel run, rank 0's
        rows, the first of the global batch)."""
        if self.model.phase != "completion" or "object_voxels" not in batch:
            return
        from ..utils.visualization import dump_training_snapshot

        was_training = self.model.training
        set_data_group(self.model, None)  # this rank's rows alone
        self.model.eval()
        try:
            with torch.no_grad():
                _, _, voxels, pids = self.model(
                    {**to_device(batch, self.device), "export_shape": True})
        finally:
            set_data_group(self.model, self.group)
            self.model.train(was_training)
        dump_training_snapshot(
            os.path.join(self.save_path or "out",
                         self.cfg["log"]["vis_path"]),
            epoch, phase, it, voxels.cpu().numpy(), pids.cpu().numpy(),
            np.asarray(batch["object_voxels"]),
            self.cfg["data"]["completion_limit_in_train"])

    def rank_noise(self, rows: int, gen: torch.Generator):
        """This rank's rows of the posterior noise of a train step's global
        batch of `rows` scenes: the draw that `ONet.compute_loss` makes
        from `gen` for the whole batch in one process ((rows x P, z_dim),
        P the proposals completed a scene); None outside the completion
        phase."""
        if self.model.phase != "completion":
            return None
        P = self.model.completion_limit
        eps = torch.randn((rows * P, self.model.completion.z_dim),
                          generator=gen, device=gen.device)
        mine = shard_rows(rows, self.group.rank, self.group.world)
        return eps[mine.start * P:mine.stop * P].to(self.device)

    def broadcast_state(self, *values: float) -> list:
        """Rank 0's parameters, running statistics and Adam state on every
        rank, and its `values` (numbers) returned; then every rank's
        tensors checked equal to rank 0's."""
        opt = self.optimizer
        state = torch.tensor([float(opt.count), *map(float, values)],
                             dtype=torch.float64, device=self.device)
        broadcast_module(self.model, self.group)
        broadcast_tensors([state, *opt.mu, *opt.nu], self.group)
        opt.count = int(state[0])
        replicated_check(self.model, self.group)
        return state[1:].tolist()

    def run_epoch(self, loader, epoch: int, phase: str,
                  board: LogBoard | None = None, print_step: int = 10):
        """One pass of `loader` in `phase` ("train" or "val"); returns the
        mean of each loss term."""
        recorder = LossRecorder(loader.batch_size)
        set_bn_momentum(self.model, bn_momentum(self.cfg, epoch))
        lr = self.plateau.lr
        vis_step = self.cfg["log"].get("vis_step", 0)
        cuda = self.device.type == "cuda"
        t0 = time.time()
        batches = iter(loader)
        it = 0
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_step = time.perf_counter()
            if (vis_step and (it + 1) % vis_step == 0
                    and (self.group is None or self.group.rank == 0)):
                self.visualize_step(batch, epoch, phase, it + 1)
            if cuda:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            dev_batch = to_device(batch, self.device)
            gen = step_generator(self.seed, epoch, phase, it, self.device)
            eps = None
            if phase == "train" and self.group is not None:
                eps = self.rank_noise(loader.batch_rows(it), gen)
            if phase == "train":
                losses = train_step(self.model, self.optimizer, dev_batch,
                                    lr, self.completion_weight, eps=eps,
                                    generator=gen)
            else:
                losses = eval_step(self.model, dev_batch,
                                   self.completion_weight, generator=gen)
            if cuda:
                events[1].record()
            keys = sorted(losses)
            losses = dict(zip(keys, torch.stack(
                [losses[k].float() for k in keys]).tolist()))
            t_end = time.perf_counter()
            self.step_times.append({
                "epoch": epoch, "phase": phase, "it": it,
                "loader_ms": (t_step - t_wait) * 1e3,
                "host_ms": (t_end - t_step) * 1e3,
                "device_ms": events[0].elapsed_time(events[1]) if cuda
                else None})
            recorder.update_loss(losses)
            it += 1
            if it % print_step == 0:
                msg = ", ".join(f"{k}: {m.avg:.4f}" for k, m in
                                sorted(recorder.loss_recorder.items()))
                self.log(f"{phase} epoch {epoch} iter {it}/{len(loader)}: "
                         f"{msg}")
                if board is not None:
                    board.add_scalars(phase, recorder.synthesize(),
                                      epoch * len(loader) + it - 1)
        self.log(f"{phase} epoch {epoch} done in {time.time() - t0:.1f}s")
        return recorder.synthesize()


def train(cfg: dict, model, train_loader, val_loader,
          checkpoint: CheckpointIO | None = None,
          board: LogBoard | None = None, start_epoch: int = 0, log=print,
          group=None):
    """The training loop: resume (the newest sibling run's `model_last`)
    when `resume` is set and one exists, else `finetune` from the `weight`
    paths when set; then each epoch a train pass, a val pass whose mean
    `total` steps the plateau schedule, `model_best` on a new best val
    loss (copied to `model_last`), else `model_last` every `log.save_step`
    epochs and at the last. Returns the `Trainer`.

    With a data `group` each rank runs this loop on its loaders' rows;
    only rank 0 passes `checkpoint` and `board`, and what it resumed or
    finetuned is broadcast before the first step."""
    trainer = Trainer(cfg, model, log=log, save_path=checkpoint.save_path
                      if checkpoint is not None else None, group=group)
    min_loss = np.inf
    if checkpoint is not None:
        resumed = False
        if cfg.get("resume"):
            meta = checkpoint.resume(model, trainer.optimizer)
            if meta is not None:
                start_epoch = int(meta.get("epoch", 0)) + 1
                min_loss = float(meta.get("min_loss", np.inf))
                trainer.plateau.lr = float(meta.get("lr", trainer.plateau.lr))
                trainer.plateau.best = min_loss
                resumed = True
        if not resumed and cfg.get("finetune"):
            for w in cfg.get("weight", []):
                checkpoint.finetune(model, w)
    if group is not None:
        start_epoch, min_loss, trainer.plateau.lr, trainer.plateau.best = (
            trainer.broadcast_state(start_epoch, min_loss, trainer.plateau.lr,
                                    trainer.plateau.best))
        start_epoch = int(start_epoch)

    epochs = cfg["train"]["epochs"]
    print_step = cfg["log"].get("print_step", 10)
    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        trainer.run_epoch(train_loader, epoch, "train", board, print_step)
        val_losses = trainer.run_epoch(val_loader, epoch, "val", board,
                                       print_step)
        eval_loss = val_losses.get("total", np.inf)
        prev_lr = trainer.plateau.lr
        trainer.plateau.step(eval_loss)
        if trainer.plateau.lr != prev_lr:
            log(f"epoch {epoch}: plateau patience exceeded, "
                f"LR {prev_lr:.2e} -> {trainer.plateau.lr:.2e}")
        if board is not None:
            board.add_scalars("schedule", {
                "lr": trainer.plateau.lr,
                "bn_momentum": bn_momentum(cfg, epoch),
                "val_total": float(eval_loss), "epoch": epoch}, epoch)
        if checkpoint is not None:
            save_step = int(cfg["log"].get("save_step", 1))
            improved = eval_loss < min_loss
            last_due = (epoch + 1) % save_step == 0 or epoch == epochs - 1
            if improved or last_due:
                meta = {"epoch": epoch,
                        "min_loss": float(min(min_loss, eval_loss)),
                        "lr": trainer.plateau.lr}
                if improved:
                    min_loss = eval_loss
                    checkpoint.save_best(model, trainer.optimizer, meta)
                    log(f"epoch {epoch}: new best val loss {eval_loss:.4f}")
                    checkpoint.copy("model_best", "model_last")
                else:
                    checkpoint.save_last(model, trainer.optimizer, meta)
    return trainer
