"""On the card (skipped without one): the readings that the limits come
from, at the cell's own size, on one seed a cell: the program within
every limit, the control (the reference in TF32) outside at least one,
and for the train cell each fault of the step outside one too. The full
readings (a dozen seeds and more) are `rfdbench/readings.py`'s."""

import pytest

from bench_tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["serve_b1", "serve_b8", "train_b8"])
def test_control_fails_and_program_passes(card, name):
    from rfdbench import harness, readings

    cell = harness.Cell(ROOT, name)
    run = readings.program_run(cell, 2 ** 31 + 101, card,
                               2 * cell.traffic["distinct_batches"])
    readings.free(run)
    numbers = run.check(control=True)
    assert all(v <= cell.limits[k] for k, v in numbers.items()), numbers
    assert any(v > cell.limits[k] for k, v in run.control_readings.items())


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "double"])
def test_train_fault_fails_on_the_card(card, fault, monkeypatch):
    from rfdbench import harness, readings
    from rfdnet_tpu_torch.train import trainer

    cell = harness.Cell(ROOT, "train_b8")
    monkeypatch.setattr(trainer, "train_step",
                        readings.FAULTS[fault](trainer.train_step))
    run = readings.program_run(cell, 2 ** 31 + 103, card, 0)
    readings.free(run)
    numbers = run.check()
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
