"""One Adam step of training stage 3 (`stage3_joint`), the port
against `rfdnet_tpu.train.trainer.make_train_step`, on the CPU: what is
held, and to what tolerance, is `torch_parity.check_train_step`'s. A file
of its own, so that xdist's `--dist loadfile` runs each stage's JAX
compile on another worker.
"""

import pytest

from torch_parity import check_train_step


@pytest.mark.parametrize("stage", ["stage3_joint"])
def test_train_step_matches_jax(stage):
    check_train_step(stage)
