"""A run whose timed path is broken underneath comes out not correct: the
card's look skipped, the rest of a run driven on the CPU at a tiny size,
once for each fault the cell can have (one card, so no exchange between
chips to leave out)."""

import pytest
import torch

from bench_tiny import run_tiny


def _alter_answer(out):
    out["grids"][0, 0, 0, 0] += 0.5


def _alter_slot(out):
    out["gen"]["proposal_ids"][0, 0, 0] += 1


def _half_batch(out):
    n = out["gen"]["valid"].shape[0] // 2
    g = out["grids"].shape[0] // 2
    out["grids"][g:] = 0.0
    out["gen"]["valid"][n:] = False
    out["parsed"]["obj_prob"][n:] = 0.0


SERVE_FAULTS = {"answer_altered": _alter_answer, "slot_altered": _alter_slot,
                "half_batch": _half_batch}


@pytest.mark.parametrize("name", ["serve_b8", "serve_b1"])
@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_served_fault_is_caught(monkeypatch, name, fault):
    from rfdnet_tpu_torch.models.iscnet import ISCNet

    generate = ISCNet.generate

    def broken(self, *args, **kw):
        out = generate(self, *args, **kw)
        SERVE_FAULTS[fault](out)
        return out

    monkeypatch.setattr(ISCNet, "generate", broken)
    out = run_tiny(name)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "double"])
def test_train_fault_is_caught(monkeypatch, fault):
    from rfdbench import readings
    from rfdnet_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "train_step",
                        readings.FAULTS[fault](trainer.train_step))
    out = run_tiny("train_b8")
    assert out["correct"] is False, out["compared"]


def test_train_loss_altered_is_caught(monkeypatch):
    from rfdnet_tpu_torch.train import trainer

    step = trainer.train_step

    def altered(*args, **kw):
        losses = step(*args, **kw)
        losses["total"] = losses["total"] * 1.01
        return losses

    monkeypatch.setattr(trainer, "train_step", altered)
    out = run_tiny("train_b8")
    assert out["correct"] is False, out["compared"]


def test_sound_run_is_correct():
    torch.manual_seed(0)
    assert run_tiny("serve_b1")["correct"] is True
