"""The port's data-parallel train step (`trainer.train_step` with the
model's data group) of the real detection model at 2 gloo ranks on the
CPU, against its own one-process step on the same batch of 8 and JAX's
step sharded over its 8-device virtual mesh
(`tests/test_train.py:139-288`; `torch_parity.dp_detection_spec`).
`_detection_world4.py` runs 4 ranks.

Against the one-process step, `tests/test_train.py`'s tolerances: the
loss terms within 1e-3 relative, the running statistics within 1e-3 /
1e-2. Against JAX, the port's one-process step tolerances (the losses at
f32's, the running statistics at STEP_STATS_ATOL / STEP_STATS_RTOL,
points on `grid_batch`'s 1/128 grid): train-mode parity's floor
(ROADMAP.md), not data parallelism's. A loss whose means divide by each
rank's own sums (DDP on the unchanged loss) misses the global loss by
more than the 1e-3 held here, which one case shows. JAX's step and the
one-process step run in this process while the ranks run in theirs.
"""

import numpy as np
import pytest

from torch_parity import (assert_dp_matches_jax,
                          assert_dp_matches_one_process, dp_detection_jax,
                          dp_detection_spec)
import torch_dist

WORLD = 2


@pytest.fixture(scope="module")
def detection():
    spec = dp_detection_spec()
    ranks = torch_dist.start(torch_dist.train_step_rank, WORLD, spec)
    jax_out = dp_detection_jax()
    one = torch_dist.alone(torch_dist.train_step_rank, spec)
    return jax_out, one, ranks.result()


def test_dp_step_matches_one_process(detection):
    _, one, ranks = detection
    assert_dp_matches_one_process(ranks, one, f"world {WORLD}")


def test_dp_step_matches_jax_sharded(detection):
    jax_out, one, ranks = detection
    assert_dp_matches_jax(one, jax_out, "one process")
    for r in ranks:
        assert_dp_matches_jax(r, jax_out, f"world {WORLD}")


def test_per_rank_denominators_miss_the_global_loss(detection):
    """The mean over the ranks of losses that divide by each rank's own
    sums (sync-BN kept) is not the global batch's loss: it misses the
    one-process total by more than the 1e-3 the DP step is held to."""
    _, one, ranks = detection
    want = one["losses"]["total"]
    per_rank = np.mean([r["per_rank"]["total"] for r in ranks])
    assert abs(per_rank - want) > 1e-3 * abs(want), (per_rank, want)
    assert ranks[0]["losses"]["total"] == pytest.approx(want, rel=1e-3)
